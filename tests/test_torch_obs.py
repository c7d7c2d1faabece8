"""The port's telemetry plane (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU.

The names are the reference's; the same recorded sequence gives the same
registry snapshot and the same Prometheus text (timestamps aside);
histogram percentiles follow numpy's and the reservoir cap keeps count
and sum exact; spans nest. The ADC saturation collector: its statistics
match the reference's; emulate's exact counters equal the reference's;
armed, the deploy output is bit-equal to the disarmed output and its
counts equal the reference's armed deploy counts (linear int8/int4,
conv); ``every_n`` folds the reference's calls; ``disable()`` stops
recording; an armed MoE forward runs its experts one ``linear`` each.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.obs import adc as jadc
from repro.obs import names as jnames
from repro_torch import api as tapi
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.interop import to_numpy_tree
from repro_torch.obs import MetricsRegistry, Tracer, adc
from repro_torch.obs import names as M

CPU = "cpu"


def test_names_are_the_references():
    def consts(mod):
        return {k: v for k, v in vars(mod).items()
                if k.isupper() and isinstance(v, str)}
    assert consts(M) == consts(jnames)
    assert len(consts(M)) == 15


def _record(reg, tracer):
    """One scripted sequence of every kind of record."""
    reg.counter(M.TOKENS_GENERATED).inc(3)
    reg.counter(M.REQUESTS_SUBMITTED).inc()
    reg.counter(M.REQUESTS_SUBMITTED).inc(2)
    reg.gauge(M.QUEUE_DEPTH).set(2)
    reg.gauge(M.ACTIVE_SLOTS).inc(1.5)
    reg.gauge(M.ACTIVE_SLOTS).dec(0.25)
    rng = np.random.RandomState(0)
    for v in rng.lognormal(size=37):
        reg.histogram(M.REQUEST_LATENCY_SECONDS).observe(v)
    for v in (1.0, 2.0, 3.0):
        reg.histogram(M.DECODE_STEP_SECONDS, max_samples=2).observe(v)
    reg.histogram("empty.seconds")
    reg.log_event("request_submitted", rid=1, prompt_len=3)
    with tracer.span("serve.prefill", rid=1):
        with tracer.span("inner"):
            pass


def _without_ts(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "duration")}
            for e in events]


def test_registry_snapshot_and_prometheus_equal_the_references(tmp_path):
    reg, jreg = MetricsRegistry(), JRegistry()
    _record(reg, Tracer(reg))
    _record(jreg, JTracer(jreg))
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    # span durations are wall-clock: compare their counts only
    for s in (snap, jsnap):
        for name in ("serve.prefill.seconds", "inner.seconds"):
            assert s["histograms"].pop(name)["count"] == 1
    assert snap == jsnap
    assert json.dumps(snap)
    drop = ("serve_prefill_seconds", "inner_seconds")
    prom = [ln for ln in reg.to_prometheus().splitlines()
            if not any(d in ln for d in drop)]
    jprom = [ln for ln in jreg.to_prometheus().splitlines()
             if not any(d in ln for d in drop)]
    assert prom == jprom
    assert _without_ts(reg.events()) == _without_ts(jreg.events())
    # reset: the same zeroed state, objects handed out still registered
    reg.reset()
    jreg.reset()
    assert reg.snapshot() == jreg.snapshot()
    assert reg.to_prometheus() == jreg.to_prometheus()
    # the JSONL log
    log = tmp_path / "events.jsonl"
    r = MetricsRegistry(event_log_path=str(log))
    r.log_event("thing", rid=1)
    r.reset()
    lines = [json.loads(s) for s in log.read_text().splitlines()]
    assert [e["kind"] for e in lines] == ["thing"] and "ts" in lines[0]


@pytest.mark.parametrize("q", [0, 25, 50, 90, 99, 100])
def test_histogram_percentiles_match_numpy(q):
    vals = np.random.RandomState(0).lognormal(size=500)
    h = MetricsRegistry().histogram("x")
    for v in vals:
        h.observe(v)
    assert h.percentile(q) == pytest.approx(np.percentile(vals, q),
                                            rel=1e-12)


def test_histogram_cap_decimates_as_the_reference():
    h, jh = (MetricsRegistry().histogram("x", max_samples=64),
             JRegistry().histogram("x", max_samples=64))
    for v in range(1000):
        h.observe(float(v))
        jh.observe(float(v))
    assert h.count == 1000 and h.sum == float(1000 * 999 // 2)
    assert h._values == jh._values and len(h._values) < 2 * 64
    assert h.summary() == jh.summary()


def test_span_nesting():
    reg = MetricsRegistry()
    tr = Tracer(reg)
    with tr.span("outer", rid=1):
        with tr.span("inner"):
            pass
    inner, outer = tr.spans
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == "outer" and outer.parent is None
    assert outer.duration >= inner.duration >= 0.0
    assert reg.histogram("outer.seconds").count == 1
    evs = reg.events("span")
    assert next(e for e in evs if e["name"] == "inner")["parent"] == "outer"
    assert next(e for e in evs if e["name"] == "outer")["rid"] == 1


@pytest.mark.parametrize("bits", [1, 3, 4])
def test_saturation_stats_match_reference(bits):
    rng = np.random.RandomState(1)
    psum = rng.randint(-40, 40, size=(6, 2, 3, 10)).astype(np.float32)
    s_p = rng.uniform(0.5, 2.0, size=(2, 3, 10)).astype(np.float32)
    sat, occ = adc.saturation_stats(torch.from_numpy(psum),
                                    torch.from_numpy(s_p), bits)
    jsat, jocc = jadc.saturation_stats(jnp.asarray(psum), jnp.asarray(s_p),
                                       bits)
    assert sat.dtype == torch.int32 and occ.dtype == torch.float32
    np.testing.assert_array_equal(sat.numpy(), np.asarray(jsat))
    np.testing.assert_allclose(occ.numpy(), np.asarray(jocc), rtol=1e-6)


# ---------------------------------------------------------------------------
# the collector on the layers, against the reference's
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    base = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                act_bits=6, psum_bits=3, array_rows=32, array_cols=32)
    base.update(kw)
    return JCIMConfig(**base), TCIMConfig(**base)


def _layer(kind, tc, seed=0):
    """Calibrated params and an input; the ADC range is then narrowed to
    0.3x the calibrated one, so that some partial sums clip."""
    rng = np.random.RandomState(seed)
    if kind == "linear":
        x = (rng.randn(8, 70) * 0.5).astype(np.float32)
        p = tapi.init_linear(torch.Generator().manual_seed(seed), 70, 24, tc,
                             device=CPU)
        p = tapi.calibrate_linear(torch.from_numpy(x), p, tc)
    else:
        x = (rng.randn(2, 8, 8, 8) * 0.5).astype(np.float32)
        p = tapi.init_conv(torch.Generator().manual_seed(seed), 3, 3, 8, 16,
                           tc, device=CPU)
        p = tapi.calibrate_conv(torch.from_numpy(x), p, tc)
    return {**p, "s_p": p["s_p"] * 0.3}, x


def _collected(fn):
    """(summary, last per-column rates, registry snapshot) of one armed
    call of ``fn`` on the port's collector."""
    with adc.sampled() as reg:
        out = fn()
        s = adc.summary()
        rates = adc._STATE.last_col_rates
        snap = reg.snapshot()
    return out, s, rates, snap


def _j_collected(fn):
    with jadc.sampled() as reg:
        out = fn()
        jadc.sync()
        s = jadc.summary()
        rates = jadc._STATE.last_col_rates
        snap = reg.snapshot()
    return out, s, rates, snap


def _same_counts(s, js, rates, jrates, snap, jsnap):
    for k in ("kernel_invocations", "samples_folded", "conversions",
              "saturated", "clip_rate", "worst_col_rate"):
        assert s[k] == js[k], k
    np.testing.assert_array_equal(rates, jrates)
    assert snap["counters"] == jsnap["counters"]
    hs, jhs = (snap["histograms"][M.ADC_COL_SATURATION_RATE],
               jsnap["histograms"][M.ADC_COL_SATURATION_RATE])
    assert hs == jhs


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_emulate_counters_equal_the_references(kind):
    jc, tc = _cfgs()
    p, x = _layer(kind, tc)
    fwd, jfwd = ((tapi.linear, japi.linear) if kind == "linear"
                 else (tapi.conv2d, japi.conv2d))
    jp = jax.tree.map(jnp.asarray, to_numpy_tree(p))
    _, s, rates, snap = _collected(lambda: fwd(torch.from_numpy(x), p, tc))
    _, js, jrates, jsnap = _j_collected(lambda: jfwd(jnp.asarray(x), jp, jc))
    _same_counts(s, js, rates, jrates, snap, jsnap)
    n = 24 if kind == "linear" else 16
    conv = (8 * 2 * 3 * 24 if kind == "linear"
            else 2 * 8 * 8 * 2 * 3 * 16)     # b(,ho,wo), S, k_tiles, N
    assert s["conversions"] == conv and 0 < s["saturated"] < conv
    assert snap["histograms"][M.ADC_COL_SATURATION_RATE]["count"] == n


@pytest.mark.parametrize("kind,pack_dtype", [("linear", "int8"),
                                             ("linear", "int4"),
                                             ("conv", "int8")])
def test_armed_deploy_is_bit_equal_and_counts_as_the_reference(kind,
                                                               pack_dtype):
    jc, tc = _cfgs(pack_dtype=pack_dtype)
    p, x = _layer(kind, tc)
    dc, jdc = tc.replace(mode="deploy"), jc.replace(mode="deploy")
    pack, fwd = ((tapi.pack_linear, tapi.linear) if kind == "linear"
                 else (tapi.pack_conv, tapi.conv2d))
    jpack, jfwd = ((japi.pack_linear, japi.linear) if kind == "linear"
                   else (japi.pack_conv, japi.conv2d))
    packed = pack(p, dc)
    xt = torch.from_numpy(x)
    y_off = fwd(xt, packed, dc)
    gathers = __import__("repro_torch.kernels.ops",
                         fromlist=["ops"])._record_saturation
    y_on, s, rates, snap = _collected(lambda: fwd(xt, packed, dc))
    assert torch.equal(y_off, y_on)
    assert torch.equal(fwd(xt, packed, dc), y_off)        # disarmed again
    assert gathers.cuda_gathers == 0                      # CPU tensors
    jpacked = jpack(jax.tree.map(jnp.asarray, to_numpy_tree(p)), jdc)
    _, js, jrates, jsnap = _j_collected(
        lambda: jfwd(jnp.asarray(x), jpacked, jdc))
    _same_counts(s, js, rates, jrates, snap, jsnap)
    # deploy counts equal emulate's exact counters
    _, es, erates, _ = _collected(lambda: fwd(xt, p, tc))
    assert (es["saturated"], es["conversions"]) == (s["saturated"],
                                                    s["conversions"])
    np.testing.assert_array_equal(erates, rates)


def test_every_n_folds_the_references_calls():
    jc, tc = _cfgs()
    p, x = _layer("linear", tc)
    xt = torch.from_numpy(x)
    with adc.sampled(every_n=3):
        for _ in range(7):
            tapi.linear(xt, p, tc)
        assert len(adc._STATE.pending) == 3            # calls 1, 4, 7
        s = adc.summary()
    assert s["kernel_invocations"] == 7 and s["samples_folded"] == 3
    assert s["conversions"] == 3 * 8 * 2 * 3 * 24
    jp = jax.tree.map(jnp.asarray, to_numpy_tree(p))
    with jadc.sampled(every_n=3):
        for _ in range(7):
            japi.linear(jnp.asarray(x), jp, jc)
        jadc.sync()
        js = jadc.summary()
    assert s == js


def test_disable_stops_recording():
    _, tc = _cfgs()
    p, x = _layer("linear", tc)
    xt = torch.from_numpy(x)
    adc.enable()
    try:
        tapi.linear(xt, p, tc)
        before = adc.totals()
        assert before[1] > 0
    finally:
        adc.disable()
    tapi.linear(xt, p, tc)
    assert adc.totals() == before and not adc._STATE.pending
    adc.reset()
    assert adc.totals() == (0, 0)
    with pytest.raises(ValueError, match="every_n"):
        adc.enable(every_n=0)


def test_armed_moe_forward_runs_per_expert(monkeypatch):
    """Armed, the MoE banks leave the batched experts path (the
    reference's gate) and every expert runs as its own ``linear``, whose
    dispatch records the side-output; the output is unchanged."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    cim = TCIMConfig(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                     act_bits=8, psum_bits=6, array_rows=32, array_cols=32)
    cfg = get_config("moonshot-v1-16b-a3b", reduced=True, cim=cim).replace(
        compute_dtype="float32", remat=False)
    model = get_model(cfg)
    art = tapi.model_artifact(init_params(model.specs(cfg), 0, device=CPU),
                              cim, device=CPU)
    dcfg = cfg.replace(cim=art.config)
    tokens = torch.randint(0, cfg.vocab, (2, 5),
                           generator=torch.Generator().manual_seed(0))
    seen = {"batched": 0, "per_expert": 0}
    for name, key in (("_batched_expert_matmul", "batched"),
                      ("_per_expert_matmul", "per_expert")):
        orig = getattr(layers, name)

        def spy(*a, _orig=orig, _key=key, **kw):
            seen[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(layers, name, spy)
    ok = {"armed": []}
    orig_ok = layers._batched_experts_ok
    monkeypatch.setattr(layers, "_batched_experts_ok",
                        lambda *a: ok["armed"].append(orig_ok(*a))
                        or ok["armed"][-1])
    y_off = model.forward(art.params, tokens, dcfg)
    assert ok["armed"] and all(ok["armed"])           # the kernel path
    ok["armed"].clear()
    with adc.sampled():
        y_on = model.forward(art.params, tokens, dcfg)
        s = adc.summary()
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers
    assert ok["armed"] and not any(ok["armed"])
    assert seen["per_expert"] == 3 * n_moe
    assert torch.equal(y_off, y_on)
    per_forward = 7 * cfg.moe.n_dense_layers + 7 * n_moe \
        + 3 * n_moe * cfg.moe.n_experts
    assert s["kernel_invocations"] == per_forward
