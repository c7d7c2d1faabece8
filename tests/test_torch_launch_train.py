"""The port's training launcher (``python -m repro_torch.launch.train``),
its LM stream and its run configuration, on the CPU.

- ``main([... "--device", "cpu"])`` trains reduced qwen3 and prints the
  reference launcher's ``[train]`` lines.
- ROADMAP fault 15, repaired: a run crashed at step 5 and relaunched
  resumes from its step-3 checkpoint and ends with the params of the
  uninterrupted run, because the stream restarts at the resumed step (the
  reference's launcher replays it from step 0).
- ROADMAP fault 16, repaired: whisper and llava get front-end input at
  ``frontend_input_shape`` (raw log-mel frames, images), where the
  reference's launcher feeds stub-embedding zeros.
- ``--cim deploy`` is refused at the first step with TypeError, by the
  reference's launcher too (a deploy tree's digit planes are integers).
- The LM stream is deterministic in (seed, step), int32 (B, T+1), its
  tokens below min(64, vocab); ``RunConfig``, ``Shape``/``SHAPES`` and
  ``cell_status``/``all_cells`` equal the reference's.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import registry as j_registry
from repro.launch import train as j_train
from repro_torch import tree_leaves
from repro_torch.checkpoint import restore_tree
from repro_torch.configs import base as t_base
from repro_torch.configs import registry as t_registry
from repro_torch.data.pipeline import lm_batch_specs, make_lm_pipeline
from repro_torch.launch import train
from repro_torch.models import registry as models
from repro_torch.runtime.fault_tolerance import InjectedFailure

RUN = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "2", "--seq", "8",
       "--lr", "1e-3", "--device", "cpu"]


def _main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def test_main_trains_and_prints_the_train_lines(tmp_path):
    seen = []
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(RUN + ["--steps", "3", "--log-every", "1",
                               "--ckpt-dir", str(tmp_path)],
                        on_metrics=lambda step, m: seen.append(step))
    lines = buf.getvalue().splitlines()
    assert rc == 0 and seen == [1, 2, 3]
    assert [ln.split()[:3] for ln in lines[:3]] == [
        ["[train]", "step", str(i)] for i in (1, 2, 3)]
    assert all("loss" in ln and "gnorm" in ln and "tok/s" in ln
               for ln in lines[:3])
    assert lines[-1].startswith("[train] done at step 3")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(RUN[:-2] + ["--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_crash_and_relaunch_equals_the_uninterrupted_run(tmp_path):
    argv = RUN + ["--steps", "8", "--ckpt-every", "3"]
    assert _main(train.main, argv + ["--ckpt-dir", str(tmp_path / "a")])[0] \
        == 0
    b = argv + ["--ckpt-dir", str(tmp_path / "b")]
    with pytest.raises(InjectedFailure):
        _main(train.main, b + ["--crash-at", "5"])
    rc, lines = _main(train.main, b)
    assert rc == 0 and lines[0] == "[train] resumed from step 3"
    got = restore_tree(str(tmp_path / "b"), device="cpu")
    want = restore_tree(str(tmp_path / "a"), device="cpu")
    assert int(got["step"]) == int(want["step"]) == 8
    for x, y in zip(tree_leaves(got["params"]), tree_leaves(want["params"])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-mistral-7b"])
def test_front_ends_get_their_input_shape(arch, tmp_path, monkeypatch):
    shapes = []
    orig = models.get_model

    def get_model(cfg):
        fns = orig(cfg)

        def forward(params, tokens, c, extra=None):
            shapes.append((tuple(extra.shape), extra.dtype))
            return fns.forward(params, tokens, c, extra)
        return dataclasses.replace(fns, forward=forward)
    monkeypatch.setattr(models, "get_model", get_model)
    rc, _ = _main(train.main, ["--arch", arch, "--reduced", "--batch", "2",
                               "--seq", "8", "--steps", "1", "--device",
                               "cpu", "--ckpt-dir", str(tmp_path)])
    cfg = t_registry.get_config(arch, reduced=True)
    want = models.frontend_input_shape(cfg, 2)
    assert rc == 0 and shapes == [(want, torch.float32)]
    # the reference's launcher feeds (batch, n_frontend_tokens, fd)
    assert want != (2, cfg.n_frontend_tokens, cfg.frontend_dim)


def test_cim_deploy_is_refused_as_by_the_reference(tmp_path):
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--batch", "2", "--seq",
            "8", "--steps", "1", "--cim", "deploy"]
    with pytest.raises(TypeError, match="int8"):
        _main(train.main, argv + ["--device", "cpu", "--ckpt-dir",
                                  str(tmp_path / "t")])
    with pytest.raises(TypeError, match="int8"):
        _main(j_train.main, argv + ["--ckpt-dir", str(tmp_path / "j")])


def test_lm_stream_is_deterministic_in_seed_and_step():
    def first(n, **kw):
        pipe = make_lm_pipeline(vocab=512, seq_len=16, global_batch=4, **kw)
        return [next(pipe)["tokens"] for _ in range(n)]
    a, b = first(4), first(4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(first(1, start_step=2)[0], a[2])
    assert not np.array_equal(first(1, seed=1)[0], a[0])
    assert not np.array_equal(a[0], a[1])
    assert a[0].dtype == np.int32 and a[0].shape == (4, 17)
    assert all(int(x.max()) < 64 for x in a)
    assert int(first(1)[0].min()) >= 0
    small = next(make_lm_pipeline(vocab=40, seq_len=64, global_batch=8))
    assert int(small["tokens"].max()) < 40
    assert lm_batch_specs(16, 4) == {"tokens": ((4, 17), torch.int32)}


def test_run_config_shapes_and_cells_match_reference():
    jf = {f.name: f.default for f in dataclasses.fields(j_base.RunConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(t_base.RunConfig)}
    assert list(jf) == list(tf)
    assert {k: v for k, v in jf.items() if k != "checkpoint_dir"} == {
        k: v for k, v in tf.items() if k != "checkpoint_dir"}
    assert t_base.RunConfig().checkpoint_dir.endswith("repro_ckpt")
    assert {k: dataclasses.astuple(v) for k, v in t_base.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in j_base.SHAPES.items()}
    assert t_registry.all_cells() == j_registry.all_cells()
    assert t_registry.cell_status("xlstm-1.3b", "long_500k") == \
        j_registry.cell_status("xlstm-1.3b", "long_500k") == (True, "ok")
