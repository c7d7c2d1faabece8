"""The kept relaid planes of the tensor-core kernels
(``repro_torch.kernels.relaid``, shared by the ADC and ADC-free wrappers):
which launches reuse a kept workspace and its layout id, and which get a
new one, so the kernel relays the planes. The bookkeeping is plain Python
and runs here with a stand-in for the library's workspace size; the
kernels that read the workspace run only on the card, where
``tests/test_torch_cuda.py`` holds them against their plain versions after
in-place writes to the planes.
"""
import gc

import pytest
import torch

from repro_torch.kernels import relaid


@pytest.fixture(autouse=True)
def _eager(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    relaid.clear_relaid_planes()
    yield
    relaid.clear_relaid_planes()


def _relaid(d, taps=1, seg=None, c=None):
    """A launch's workspace, of a stand-in size (the library's workspace
    function sizes it on the card)."""
    s, kt, rows, n = d.shape[-4:]
    seg = rows if seg is None else seg
    return relaid.relaid_planes(d, kt * s * n * taps * seg,
                                (taps, seg, kt * rows if c is None else c))


def _planes(*shape):
    return torch.randint(-8, 8, shape, dtype=torch.int8)


def test_second_launch_on_the_same_planes_reuses_the_workspace():
    d = _planes(3, 2, 16, 8)
    work, layout, kept = _relaid(d)
    assert kept is None and layout.value == 0
    assert work.numel() == 2 * 3 * 8 * 16 and work.dtype == torch.uint8
    layout.value = 1234                    # what the kernel stores
    work2, layout2, kept2 = _relaid(d)
    assert work2 is work and layout2 is layout and kept2 == 1234


@pytest.mark.parametrize("expert", [0, 1, 2])
def test_views_of_one_bank_keep_one_workspace_each(expert):
    bank = _planes(3, 3, 2, 16, 8)         # (experts, S, kt, rows, N)
    works = [_relaid(bank[e])[0] for e in range(3)]
    again = _relaid(bank[expert])[0]       # a new view object, same slice
    assert again is works[expert]
    assert len({id(w) for w in works}) == 3


@pytest.mark.parametrize("write", ["whole", "slice", "through_the_bank"])
def test_an_in_place_write_to_the_planes_gives_a_new_workspace(write):
    bank = _planes(2, 3, 2, 16, 8)
    d = bank[1]
    work, layout, _ = _relaid(d)
    layout.value = 99
    if write == "whole":
        d.neg_()
    elif write == "slice":
        d[0, 0, 0, 0] = 3
    else:
        bank[0].zero_()                    # another expert's slice
    work2, layout2, kept = _relaid(bank[1])
    assert work2 is not work and layout2.value == 0 and kept is None


def test_each_call_geometry_keeps_its_own_workspace():
    d = _planes(3, 2, 126, 8)
    matmul = _relaid(d)[0]
    conv = _relaid(d, taps=9, seg=14, c=16)[0]
    conv_other_c = _relaid(d, taps=9, seg=14, c=28)[0]
    assert len({id(matmul), id(conv), id(conv_other_c)}) == 3
    assert _relaid(d, taps=9, seg=14, c=16)[0] is conv


def test_the_entry_goes_with_the_planes():
    d = _planes(3, 2, 16, 8)
    key = id(d)
    _relaid(d[:, :1])                      # a view keeps the base alive
    assert key in relaid._KEPT
    del d
    gc.collect()
    assert key not in relaid._KEPT


def test_clear_frees_what_is_kept():
    d = _planes(3, 2, 16, 8)
    work = _relaid(d)[0]
    relaid.clear_relaid_planes()
    assert _relaid(d)[0] is not work


def test_a_capture_uses_what_is_kept_and_keeps_nothing_new(monkeypatch):
    kept_d, new_d = _planes(3, 2, 16, 8), _planes(3, 2, 16, 8)
    work, layout, _ = _relaid(kept_d)
    layout.value = 7
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    work2, layout2, kept = _relaid(kept_d)
    assert work2 is work and kept == 7
    relaid.check_capture(layout2, kept, "k")   # same layout: fine
    fresh = _relaid(new_d)
    assert fresh[2] is None and _relaid(new_d)[0] is not fresh[0]
    layout2.value = 8                      # the launch relaid kept planes
    with pytest.raises(RuntimeError, match="CUDA-graph capture"):
        relaid.check_capture(layout2, kept, "k")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    assert _relaid(kept_d)[0] is not work  # the stale entry was dropped
