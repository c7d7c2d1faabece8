"""Data parallel serving (``launch.cells.serve_rows``): every family's serve
cell on a ``("data", "model")`` mesh of (2, 2) gloo ranks on the CPU, each
rank stepping its own rows, against the reference's serve cell
(``repro.launch.cells.build_cell``) jitted with its ``in_shardings`` and
``out_shardings`` on four forced host devices.

One subprocess runs the reference under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (``AxisType.Auto``
axes, ROADMAP fault 20; its session mesh installed for flash decode and
the expert-parallel MoE) while the port's ranks run
(``tests/_torch_serve_ranks.py``, spawned once for the file). The JAX
package initialises every param tree; the prompt, the decode tokens and
whisper's encoder states are numpy from seeds. A cell of batch 8 and
max_len 16 takes a prefill of 8 tokens and two decode steps of given
tokens; the cases (``_torch_serve_ranks.CASES``) are llama3 with flash
decode off and on, each with the float and the int8 KV cache, qwen3
(tied), deepseek-v3 (MLA, its latent cache's time over ``"model"``) with
flash decode off and on (the sequence-parallel MLA decode; the
reference ignores the flag for MLA, so the port's merge is held against
its plain attention), moonshot (the expert-parallel MoE), whisper
(``enc_out``), llava, zamba2 (the SSD state's heads over ``"model"``)
and xlstm, in float32 compute.

- Each rank's logits rows and its rows of every cache leaf equal the
  reference's rows at rtol 1e-5 / atol 1e-4; integer leaves (``len``,
  the int8 codes) exactly.
- Where flash decode is off the data parallel step equals the port's own
  step on the whole batch (every rank all rows, the same placements) bit
  for bit, rows and caches.
- Every cache leaf holds its rows over ``"data"`` (a rank allocates half),
  K/V, their int8 scales, MLA's ``ckv`` and ``krope`` their time and the
  SSD state its heads over ``"model"`` (half again), flash decode or not,
  the logits come back placed as the reference's ``logits_sh``, no
  all-gather runs over ``"data"`` where the params are not FSDP-placed,
  and a model's own ``decode_step`` refuses a cache holding its rows.
- The ADC collector's totals over a data parallel prefill (CIM emulate)
  equal one device's, and over a deepseek-v3 prefill and decode step
  with the sequence-parallel MLA decode too.
- Whisper's and llava's step with the front-end input (whisper's encoder
  on the rank's rows, llava's image prefill) equals the one-device
  ``forward`` on those rows at rtol 1e-5 / atol 1e-4.
"""
import contextlib
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

import _torch_mesh_ranks as R
import _torch_serve_ranks as S
from repro.configs.registry import get_config as j_get_config
from repro.launch.cells import RUN_HINTS, apply_hints
from repro.models.registry import frontend_input_shape as j_frontend_shape
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-4)
ROWS = S.BATCH // S.MESH[0][0]
#: the cache leaves the reference's ``cache_shardings`` places over
#: ``"model"`` on their dim 2: the time of K/V, their int8 scales and
#: MLA's latent cache, the heads of the SSD state
MODEL_SPLIT = ("k", "v", "k_scale", "v_scale", "ckv", "krope", "ssd")

_REFERENCE = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs.base import SHAPES, Shape
    from repro.launch.cells import build_cell
    from repro.models.registry import get_model
    from repro.nn.module import session_mesh
    assert len(jax.devices()) == 4
    d = sys.argv[1]
    with open(d + "/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    b, max_len, name = inp["batch"], inp["max_len"], inp["shape"]
    SHAPES[name] = Shape(name, "decode", max_len, b)
    shape, axes = inp["mesh"]
    mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * 2)
    out = {}
    for case, c in inp["cases"].items():
        cell = build_cell(c["arch"], name, mesh, reduced=True,
                          overrides=c["overrides"])
        model = get_model(cell.cfg)
        with session_mesh(mesh, cell.rules):
            step = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                           out_shardings=cell.out_shardings)
            params = jax.device_put(jax.tree.map(jnp.asarray, c["params"]),
                                    cell.in_shardings[0])
            cache = model.init_cache(cell.cfg, b, max_len)
            if "enc_out" in cache:
                cache["enc_out"] = jnp.asarray(c["enc_out"])
            cache = jax.device_put(cache, cell.in_shardings[1])
            calls = []
            for t in c["tokens"]:
                logits, cache = step(params, cache, jnp.asarray(t))
                calls.append((np.asarray(logits),
                              jax.tree.map(np.asarray, cache)))
        out[case] = calls
    with open(d + "/reference.pkl", "wb") as f:
        pickle.dump(out, f)
""")


def _params(arch, memo={}):
    """The JAX package's init (seed 0) of ``arch``'s reduced cell config
    (its run hints: deepseek's bfloat16 params), as numpy."""
    if arch not in memo:
        cfg = apply_hints(j_get_config(arch, reduced=True), arch)
        memo[arch] = jax.tree.map(np.asarray, jax.jit(
            lambda k: j_init_params(j_get_model(cfg).specs(cfg), k))(
                jax.random.PRNGKey(0)))
    return memo[arch]


def _inputs():
    cases = {}
    for i, (name, (arch, _)) in enumerate(S.CASES.items()):
        cfg = j_get_config(arch, reduced=True)
        rs = np.random.RandomState(40 + i)
        c = dict(arch=arch, overrides=S.overrides(name),
                 params=_params(arch),
                 tokens=S.numpy_tokens(cfg.vocab, 20 + i))
        if cfg.family == "whisper":
            c["enc_out"] = rs.randn(S.BATCH, cfg.n_frontend_tokens,
                                    cfg.d_model).astype(np.float32)
        if name in S.FRONTEND:
            c["frontend"] = rs.randn(
                *j_frontend_shape(cfg, S.BATCH)).astype(np.float32)
        cases[name] = c
    return dict(cases=cases, batch=S.BATCH, max_len=S.MAX_LEN,
                shape=S.SHAPE_NAME, mesh=S.MESH)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's ranks' results, the reference's, the inputs)."""
    out = tmp_path_factory.mktemp("serve_cells")
    inputs = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(out)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    with contextlib.ExitStack() as stack:
        stack.callback(lambda: ref.poll() is None and ref.kill())
        ranks = R.run_ranks(S.body, WORLD, str(out), timeout_s=300)
        log = ref.communicate(timeout=300)[0]
    assert ref.returncode == 0, log[-3000:]
    with open(out / "reference.pkl", "rb") as f:
        reference = pickle.load(f)
    return ranks, reference, inputs


def _rows(x, dim, d):
    """Data rank ``d``'s rows (along ``dim``) of a whole (reference)
    array."""
    return np.take(np.asarray(x), np.arange(d * ROWS, (d + 1) * ROWS),
                   axis=dim)


def _leaf_close(got, want, msg):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want.astype(np.float32), err_msg=msg,
                                   **TOL)


@pytest.mark.parametrize("name", list(S.CASES))
def test_serve_cell_rows_match_the_reference(runs, name):
    ranks, ref, _ = runs
    want = ref[name]
    for res in ranks:
        d = res["rows"]
        calls = res["serve"][name]["calls"]
        assert len(calls) == len(want) == 1 + S.DECODE_STEPS
        for i, ((logits, cache), (w_logits, w_cache)) in enumerate(
                zip(calls, want)):
            _leaf_close(logits, _rows(w_logits, 0, d), f"{name} call {i}")
            flat = dict(S._flat(w_cache))
            assert set(cache) == set(flat), (sorted(cache), sorted(flat))
            for path, leaf in cache.items():
                _leaf_close(leaf, _rows(flat[path], S.row_dim(path), d),
                            f"{name} call {i} {path}")


@pytest.mark.parametrize("name", [n for n, (_, ov) in S.CASES.items()
                                  if not ov.get("flash_decode")])
def test_data_parallel_step_equals_the_whole_batch_step(runs, name):
    """No rank computes another rank's rows, and the split changes no
    arithmetic: each call's logits rows and cache rows equal the whole
    batch's step on the same placements bit for bit."""
    ranks, _, _ = runs
    for res in ranks:
        r = res["serve"][name]
        for (logits, cache), (w_logits, w_cache) in zip(r["calls"],
                                                        r["whole"]):
            assert logits.equal(w_logits), name
            assert set(cache) == set(w_cache)
            for path in cache:
                assert cache[path].equal(w_cache[path]), (name, path)


@pytest.mark.parametrize("name", list(S.CASES))
def test_cache_and_logits_hold_the_ranks_rows(runs, name):
    ranks, _, _ = runs
    arch = S.CASES[name][0]
    fsdp = RUN_HINTS[arch].get("fsdp", False)
    vocab = j_get_config(arch, reduced=True).vocab
    for res in ranks:
        r = res["serve"][name]
        split = set()
        for path, (kind, full, local) in r["placed"].items():
            dim = S.row_dim(path)
            assert kind == "DTensor", (name, path)
            assert local[dim] == full[dim] // 2, (name, path, full, local)
            leaf = path.rsplit("/", 1)[-1]
            if leaf in MODEL_SPLIT:
                assert local[2] == full[2] // 2, (name, path, full, local)
                split.add(leaf)
            elif len(full) > 2 and dim != 2:
                assert local[2] == full[2], (name, path, full, local)
        want = {"transformer": {"ckv", "krope"} if "deepseek" in name
                else {"k", "v"} | ({"k_scale", "v_scale"}
                                   if "kv8" in name else set()),
                "zamba2": {"k", "v", "ssd"}, "whisper": {"k", "v"},
                "llava": {"k", "v"}, "xlstm": set()}[
                    j_get_config(arch, reduced=True).family]
        assert split == want, (name, split, want)
        kind, full, local = r["logits_placed"]
        assert kind == "DTensor" and full[0] == S.BATCH
        assert local[0] == ROWS and local[2] == vocab // 2
        if not fsdp:
            assert r["axes"].get(("all-gather", "data"), 0) == 0, r["axes"]
        assert r["axes"].get(("all-gather", "model"), 0) > 0
        assert r["refused"] and "serve_rows" in r["refused"]


@pytest.mark.parametrize("name", [n for n, (_, ov) in S.CASES.items()
                                  if ov.get("flash_decode")])
def test_flash_decode_merges_each_layer_over_model(runs, name):
    """A decode step with flash decode merges every attention layer's
    partial softmaxes over ``"model"`` (GQA's flash decode, the
    sequence-parallel MLA decode): three all-reduces a layer and decode
    step (the max, ``l`` and ``acc``) more than the same case with flash
    decode off, whose decode gathers the cache at use."""
    ranks, _, _ = runs
    arch = S.CASES[name][0]
    want = 3 * j_get_config(arch, reduced=True).n_layers * S.DECODE_STEPS
    key = ("all-reduce", "model")
    for res in ranks:
        on = res["serve"][name]["axes"].get(key, 0)
        off = res["serve"][name.replace("_flash", "")]["axes"].get(key, 0)
        assert on - off == want, (name, on, off, want)


def test_adc_totals_over_a_data_parallel_step_equal_one_device(runs):
    """Under a data parallel step every ADC record is a part over the
    batch axes too: the totals over the mesh equal one device's."""
    ranks, _, _ = runs
    for res in ranks:
        one, rows = res["adc"]
        assert tuple(rows) == tuple(one) and one[0] > 0 and one[1] > 0


def test_adc_totals_over_a_sequence_parallel_mla_step_equal_one_device(
        runs):
    """The sequence-parallel MLA decode's ``wkv_b`` records are parts over
    ``"model"`` (each rank's time block) and the data ranks: the totals
    over the mesh equal one device's."""
    ranks, _, _ = runs
    for res in ranks:
        one, rows = res["adc_mla"]
        assert tuple(rows) == tuple(one) and one[0] > 0 and one[1] > 0


@pytest.mark.parametrize("name", S.FRONTEND)
def test_front_end_prefill_equals_the_forward(runs, name):
    ranks, _, _ = runs
    for res in ranks:
        rows, one = res["frontend"][name]
        assert rows.shape == one.shape
        np.testing.assert_allclose(rows.numpy(), one.numpy(), **TOL)
