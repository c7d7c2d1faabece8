"""llava-next-mistral-7b (a Mistral text backbone with a patch-embed conv
front end and an MLP projector) on the port against the JAX package, on
the CPU: ``embed_patches`` (a 4x4 stride-4 VALID conv on (B, 16, 16, 3)
images, taps 16 over 32-row arrays at the reduced size), the projector,
and ``forward`` with 4-D images in emulate and deploy (the image tokens
prepended to the text), then the reduced entry through the zoo's checks
(``tests/_torch_zoo.py``; decode and the engine serve text).

Inputs are made with numpy from a seed; params are the reference's own.
Patch embeddings, projections and logits agree within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zoo as zoo
from repro.models import llava as JV
from repro_torch.models import llava as TV

ARCH = "llava-next-mistral-7b"
B = zoo.B


@pytest.fixture(scope="module")
def reference():
    return zoo.make_reference(ARCH)


@pytest.mark.parametrize("mode", ["emulate", "deploy"])
def test_embed_and_project_patches_match_reference(reference, mode):
    """Images -> (B, 16, frontend_dim) patch embeddings through the CIM
    conv, then the ReLU projector into d_model: both at 1e-4."""
    jcfg, tcfg, j_params, params = zoo._decode_setup(reference, mode)
    img = reference["extra"]
    assert img.shape == (B, 16, 16, 3)
    want = jax.jit(lambda p, x: JV.embed_patches(p, x, jcfg))(
        j_params, jnp.asarray(img))
    got = TV.embed_patches(params, torch.from_numpy(img), tcfg)
    assert got.shape == (B, tcfg.n_frontend_tokens, tcfg.frontend_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **zoo.LOGIT_TOL)
    want_p = jax.jit(lambda p, x: JV.project_patches(p, x, jcfg))(j_params,
                                                                 want)
    got_p = TV.project_patches(params, got, tcfg)
    assert got_p.shape == (B, tcfg.n_frontend_tokens, tcfg.d_model)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               **zoo.LOGIT_TOL)


@pytest.mark.parametrize("mode", ["emulate", "deploy"])
def test_forward_with_images_matches_reference(reference, mode):
    """4-D images select the conv front end: logits over 16 image tokens
    and 8 text tokens at 1e-4; 3-D stub patch embeddings take the
    projector alone; no front-end input gives the text logits."""
    jcfg, tcfg, j_params, params = zoo._decode_setup(reference, mode)
    tokens = reference["tokens"]
    rng = np.random.default_rng(9)
    stub = (rng.standard_normal((B, tcfg.n_frontend_tokens,
                                 tcfg.frontend_dim)) * 0.1).astype(np.float32)
    fwd = jax.jit(lambda p, t, e: JV.forward(p, t, jcfg, e))
    for extra in (reference["extra"], stub, None):
        want = (fwd(j_params, jnp.asarray(tokens), None) if extra is None
                else fwd(j_params, jnp.asarray(tokens), jnp.asarray(extra)))
        got = TV.forward(params, torch.from_numpy(np.array(tokens)), tcfg,
                         None if extra is None else torch.from_numpy(extra))
        n_img = 0 if extra is None else tcfg.n_frontend_tokens
        assert got.shape == (B, n_img + zoo.T, tcfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **zoo.LOGIT_TOL)


def test_frontend_input_shapes_match_reference():
    """``frontend_input_shape`` of every entry, full and reduced, with the
    conv front end on and off."""
    from repro.configs.registry import ARCHS as J_ARCHS
    from repro.configs.registry import get_config as j_get_config
    from repro.models.registry import frontend_input_shape as j_shape
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import frontend_input_shape
    for arch in J_ARCHS:
        for reduced in (False, True):
            for conv in (False, True):
                kw = dict(conv_frontend=conv)
                if conv and arch.startswith("llava"):
                    kw["patch_size"] = 14 if not reduced else 4
                want = j_shape(j_get_config(arch, reduced=reduced).replace(
                    **kw), 3)
                got = frontend_input_shape(get_config(
                    arch, reduced=reduced).replace(**kw), 3)
                assert got == want, (arch, reduced, conv)


@pytest.mark.parametrize("mode,pack_dtype", [("emulate", "int8"),
                                             ("deploy", "int4")])
def test_specs_match_reference(mode, pack_dtype):
    zoo.check_specs(ARCH, mode, pack_dtype)


def test_emulate_and_deploy_match_reference(reference):
    zoo.check_emulate_and_deploy(reference)


@pytest.mark.parametrize("mode", ["emulate", "deploy"])
def test_decode_matches_reference_decode(reference, mode):
    zoo.check_decode_matches_reference(reference, mode)


def test_decode_matches_forward_without_cim(reference):
    zoo.check_decode_matches_forward_without_cim(reference)


def test_engine_serves_the_reference_engines_tokens(reference):
    zoo.check_engine_tokens(reference)
