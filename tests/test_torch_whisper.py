"""whisper-small (an encoder-decoder with a conv stem) on the port against
the JAX package, on the CPU: ``encode`` through the two-conv stem on raw
log-mel frames (emulate, and deploy from the reference's artifact: the
stem's convs on the fused conv path), ``decode`` with per-row position
offsets over a self-attention cache and cross-attention to the encoder
states, then the reduced entry through the zoo's checks
(``tests/_torch_zoo.py``); the engine is the slot engine with the
encoder states injected into its cache, against the JAX engine driven
the same way (``examples/serve_whisper_cim.py``).

Inputs are made with numpy from a seed; params are the reference's own.
Encoder states and logits agree within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zoo as zoo
from repro.models import whisper as JW
from repro_torch.models import whisper as TW

ARCH = "whisper-small"
B = zoo.B


@pytest.fixture(scope="module")
def reference():
    return zoo.make_reference(ARCH)


@pytest.mark.parametrize("mode", ["emulate", "deploy"])
def test_encode_through_the_conv_stem_matches_reference(reference, mode):
    """Raw log-mel (B, 48, 16) through conv1 (1x3, stride 1) and conv2 (1x3,
    stride 2, SAME on an even width), then the encoder: (B, 24, d) states
    at 1e-4 of the reference's."""
    jcfg, tcfg, j_params, params = zoo._decode_setup(reference, mode)
    mel = reference["extra"]
    assert mel.shape == (B, 2 * tcfg.n_frontend_tokens, tcfg.frontend_dim)
    want = jax.jit(lambda p, m: JW.encode(p, m, jcfg))(j_params,
                                                      jnp.asarray(mel))
    got = TW.encode(params, torch.from_numpy(mel), tcfg)
    assert got.shape == (B, tcfg.n_frontend_tokens, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **zoo.LOGIT_TOL)
    stem = TW._conv_stem(params, torch.from_numpy(mel), tcfg)
    np.testing.assert_allclose(
        stem.numpy(), np.asarray(jax.jit(
            lambda p, m: JW._conv_stem(p, m, jcfg))(j_params,
                                                    jnp.asarray(mel))),
        **zoo.LOGIT_TOL)


@pytest.mark.parametrize("mode", ["emulate", "deploy"])
def test_decode_with_per_row_offsets_matches_reference(reference, mode):
    """Three tokens per row decoded over a cache whose rows hold 2 and 5
    positions (per-row ``position_offset``, the K/V rows written at each
    row's length), with cross-attention to random encoder states: logits
    at 1e-4 and the written caches at 1e-5."""
    jcfg, tcfg, j_params, params = zoo._decode_setup(reference, mode)
    rng = np.random.default_rng(5)
    L, kvh, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.resolved_head_dim
    enc = rng.standard_normal((B, tcfg.n_frontend_tokens,
                               tcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, tcfg.vocab, (B, 3)).astype(np.int32)
    k0, v0 = (rng.standard_normal((L, B, 12, kvh, hd)).astype(np.float32)
              for _ in range(2))
    lens = np.tile(np.array([2, 5], np.int32), (L, 1))
    want, want_c = jax.jit(lambda p, t, e, c: JW.decode(
        p, t, e, jcfg, cache=c, position_offset=c["len"][0]))(
        j_params, jnp.asarray(tokens), jnp.asarray(enc),
        {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
         "len": jnp.asarray(lens)})
    cache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(
        v0.copy()), "len": torch.from_numpy(lens.copy())}
    got, got_c = TW.decode(params, torch.from_numpy(tokens),
                           torch.from_numpy(enc), tcfg, cache=cache,
                           position_offset=cache["len"][0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **zoo.LOGIT_TOL)
    np.testing.assert_array_equal(got_c["len"].numpy(), lens + 3)
    for f in ("k", "v"):
        np.testing.assert_allclose(got_c[f].numpy(), np.asarray(want_c[f]),
                                   rtol=1e-5, atol=1e-5)


def test_init_cache_matches_reference():
    """The decoder's KV cache and the zero ``enc_out``, as the
    reference's."""
    from repro.models.registry import get_model as j_get_model
    from repro_torch.models.registry import get_model
    jcfg, tcfg = zoo.cfgs(ARCH)
    want = j_get_model(jcfg).init_cache(jcfg, 3, 20)
    got = get_model(tcfg).init_cache(tcfg, 3, 20, device=zoo.CPU)
    assert set(got) == set(want) == {"k", "v", "len", "enc_out"}
    for f, w in want.items():
        assert tuple(got[f].shape) == w.shape, f
        assert str(got[f].dtype).replace("torch.", "") == w.dtype.name, f


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


def test_engine_with_injected_encoder_states_serves_the_reference_tokens(
        reference):
    zoo.check_engine_tokens(reference)


def test_entry_points_default_to_cuda():
    """Without a card and without ``device="cpu"`` the cache raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    _, tcfg = zoo.cfgs(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TW.init_cache(tcfg, 2, 8)
