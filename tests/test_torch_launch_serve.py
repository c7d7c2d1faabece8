"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against the reference's (``repro.launch.serve``), on the CPU.

On an artifact the JAX package saved (the reference launcher's CIM
config), both launchers' ``main`` print the same tokens for qwen3-0.6b and
zamba2-2.7b at their reduced configs. Both run in float32 here: the
configs' bfloat16 rounds at other places in the two frameworks, which
moves zamba2's greedy tokens (the launchers have no compute-dtype flag,
so the test sets it in each package's registry). ``--mesh 2`` on the
CPU raises on the default ``nccl`` backend, naming ``gloo`` (the sharded
launcher runs in tests/test_torch_mesh.py), and ``--device cuda`` raises
without a card.
The drift, health and telemetry flags run on ``--cim deploy``, and the
metrics JSON has the reference's keys apart from the timing spans'
(each launcher's own drift fields: randomness does not cross
frameworks); ``--adc-sample`` leaves the collector disarmed after the
run. whisper through the port's launcher decodes against the encoder
states of its seeded log-mel frames: its tokens equal those of the
engine driven by hand with the same states.
"""
import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

import repro.configs.registry as j_registry
import repro_torch.configs.registry as t_registry
from repro.api import model_artifact
from repro.core.cim_linear import CIMConfig
from repro.launch import serve as j_serve
from repro.models.registry import get_model
from repro.nn import init_params
from repro.obs import adc as j_adc
from repro_torch.launch import serve as t_serve
from repro_torch.obs import adc

#: the reference launcher's CIM config (``src/repro/launch/serve.py``)
LAUNCH_CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                  act_bits=8, psum_bits=6, array_rows=128, array_cols=128)
RUN = ["--reduced", "--batch", "2", "--prompt-len", "6", "--new-tokens",
       "5"]
DRIFT = ["--cim", "deploy", "--drift-col-rate", "1e-3", "--drift-cell-rate",
         "2e-4", "--drift-read-sigma", "0.02", "--drift-t0", "300",
         "--health", "--report-every", "2", "--adc-sample", "2"]


@pytest.fixture
def float32(monkeypatch):
    """Both packages' registries give float32 configs."""
    for reg in (j_registry, t_registry):
        orig = reg.get_config
        monkeypatch.setattr(reg, "get_config",
                            lambda *a, _o=orig, **k: _o(*a, **k).replace(
                                compute_dtype="float32"))


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return buf.getvalue().splitlines()


def _tokens(lines):
    return next(ln for ln in lines if "sample continuation" in ln)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-2.7b"])
def test_same_tokens_as_the_reference_launcher(arch, float32, tmp_path):
    cim = CIMConfig(**LAUNCH_CIM, use_kernel=False)
    cfg = j_registry.get_config(arch, reduced=True, cim=cim)
    params = init_params(get_model(cfg).specs(cfg), jax.random.PRNGKey(0))
    path = str(tmp_path / "art")
    model_artifact(params, cim).save(path)
    argv = ["--arch", arch, "--artifact", path] + RUN
    want = _run(j_serve.main, argv)
    got = _run(t_serve.main, argv + ["--device", "cpu"])
    assert _tokens(got) == _tokens(want)
    shape = [ln.split(" tokens in")[0] for ln in want if "generated" in ln]
    assert [ln.split(" tokens in")[0] for ln in got
            if "generated" in ln] == shape
    assert [ln for ln in got if "admission" in ln] == \
        [ln for ln in want if "admission" in ln]


def test_mesh_raises_naming_item_12():
    with pytest.raises(SystemExit, match="gloo"):
        t_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--cim", "deploy",
                      "--mesh", "2", "--device", "cpu"])


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--arch", "qwen3-0.6b", "--reduced"])


def _keys(tree, prefix=""):
    """'/'-joined key paths of a JSON tree, histogram summaries and span
    names left out of the metric names (they are the timings)."""
    out = set()
    for k, v in tree.items():
        p = f"{prefix}/{k}"
        out.add(p)
        if isinstance(v, dict) and not k.endswith(".seconds"):
            out |= _keys(v, p)
    return out


@pytest.fixture
def reference_collector():
    """The reference launcher arms its ADC collector and leaves it armed;
    disarm it after the test, so later tests in the process see it off."""
    yield
    j_adc.disable()


def test_drift_health_and_metrics_flags_run(float32, reference_collector,
                                            tmp_path):
    argv = ["--arch", "qwen3-0.6b"] + RUN + DRIFT
    j_path, t_path = tmp_path / "j.json", tmp_path / "t.json"
    err = io.StringIO()
    _run(j_serve.main, argv + ["--metrics-out", str(j_path)])
    with contextlib.redirect_stderr(err):
        got = _run(t_serve.main, argv + ["--metrics-out", str(t_path),
                                         "--device", "cpu"])
    assert not adc.enabled()
    assert any(ln.startswith("[serve] health: ") for ln in got)
    assert "[serve.metrics] t=" in err.getvalue()
    want, have = (json.loads(p.read_text()) for p in (j_path, t_path))
    assert _keys(have) == _keys(want)
    assert have["health"]["drifting"] and have["health"]["t"] == 305
    assert have["throughput"]["tokens_generated"] == 2 * 5
    assert have["saturation"]["kernel_invocations"] > 0


def test_whisper_decodes_against_its_seeded_frames():
    """The launcher's whisper tokens are those of an engine driven by hand
    with the encoder states of the same seeded frames, and differ from
    silent audio's."""
    from repro_torch.api import model_artifact as t_artifact
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
    from repro_torch.models import whisper
    from repro_torch.models.registry import frontend_input_shape
    from repro_torch.models.registry import get_model as t_get_model
    from repro_torch.nn.module import init_params as t_init
    from repro_torch.serve.engine import engine_from_artifact
    argv = ["--arch", "whisper-small", "--cim", "deploy", "--seed", "3",
            "--device", "cpu"] + RUN
    got = _tokens(_run(t_serve.main, argv))
    cim = TCIMConfig(**LAUNCH_CIM)
    cfg = get_config("whisper-small", reduced=True, cim=cim)
    params = t_init(t_get_model(cfg).specs(cfg), 3, device="cpu")
    art = t_artifact(params, cim, device="cpu")
    frames = torch.randn(frontend_input_shape(cfg, 2),
                         generator=torch.Generator().manual_seed(3)) * 0.1
    prompts = np.random.RandomState(3).randint(0, cfg.vocab, (2, 6)).astype(
        np.int32)

    def serve(enc):
        eng = engine_from_artifact(art, cfg, batch_size=2, max_len=256,
                                   seed=3, device="cpu")
        eng.cache["enc_out"] = enc
        return eng.generate_batch(prompts, 5)
    dcfg = cfg.replace(cim=art.config)
    want = serve(whisper.encode(art.params, frames, dcfg))
    assert got == f"[serve] sample continuation: {want[0][:16].tolist()}"
    silent = serve(torch.zeros_like(whisper.encode(art.params, frames,
                                                   dcfg)))
    assert not np.array_equal(silent, want)
