"""The dense transformers of the zoo on the port against the JAX package,
on the CPU: llama3-8b, qwen3-0.6b (qk-norm, tied embeddings), granite-8b
(tied embeddings) and olmo-1b (non-parametric LayerNorm), each at its
``reduced()`` size (``tests/_torch_zoo.py``: the CIM config, the
tolerances and the checks; deepseek-v3-671b's are in
``tests/test_torch_mla.py``).
"""
import pytest

import _torch_zoo as zoo

ARCHS = ("llama3-8b", "qwen3-0.6b", "granite-8b", "olmo-1b")


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    return zoo.make_reference(request.param)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,pack_dtype", [("emulate", "int8"),
                                             ("deploy", "int4")])
def test_specs_match_reference(arch, mode, pack_dtype):
    zoo.check_specs(arch, mode, pack_dtype)


def test_emulate_and_deploy_match_reference(reference):
    zoo.check_emulate_and_deploy(reference)


@pytest.mark.parametrize("mode", ["emulate", "deploy"])
def test_decode_matches_forward(reference, mode):
    zoo.check_decode_matches_forward(reference, mode)


def test_engine_serves_the_reference_engines_tokens(reference):
    zoo.check_engine_tokens(reference)


def test_registry_resolves_every_transformer_entry():
    """``get_config`` resolves all ten entries of the reference's registry,
    full and reduced, with the reference's fields (the recurrent and
    multimodal ones' too), and ``get_model`` their families."""
    from repro.configs.registry import ARCHS as J_ARCHS
    from repro.configs.registry import get_config as j_get_config
    from repro_torch.configs.registry import ARCHS as PORTED, get_config
    from repro_torch.models.registry import get_model
    assert set(PORTED) == set(J_ARCHS) == {
        "moonshot-v1-16b-a3b", "deepseek-v3-671b", *ARCHS, "xlstm-1.3b",
        "zamba2-2.7b", "whisper-small", "llava-next-mistral-7b"}
    for arch in PORTED:
        for reduced in (False, True):
            got = get_config(arch, reduced=reduced)
            want = j_get_config(arch, reduced=reduced)
            assert get_model(got).forward is not None
            for f in ("name", "family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "d_ff", "vocab", "head_dim", "norm",
                      "qk_norm", "rope_theta", "max_seq", "tie_embeddings",
                      "moe", "mla", "kv_cache_dtype", "ssm", "attn_every",
                      "enc_layers", "n_frontend_tokens", "frontend_dim",
                      "conv_frontend", "patch_size", "sub_quadratic", "act"):
                g, w = getattr(got, f), getattr(want, f)
                assert (g is None) == (w is None), (arch, f)
                if g is not None and hasattr(w, "__dataclass_fields__"):
                    g, w = vars(g), vars(w)
                assert g == w, (arch, f)
