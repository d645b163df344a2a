"""Every entry of the expression catalog (tests/torch_expr_catalog.py) on
the card against the same query on the CPU.

Marked `cuda`: they skip without an NVIDIA GPU. Each entry and variant
runs on 4096 rows with nulls (the numeric frame's i and x), and the
catalog's hole entries also after its breaker, through the port on
`device="cuda"` and on `device="cpu"`; the results are held to each
other within the entry's tolerance (`torch_expr_catalog.TOLERANCE`), a
sampling entry to its properties, a refused entry to the CPU's error.
Run them on a machine with a card, without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_exprs.py
"""

import pytest
import torch

import polaroid_tpu_torch as pt
import torch_expr_catalog as C

pytestmark = pytest.mark.cuda

N_ROWS = 4096


def _frames(device):
    cols, valid = C.num_data(N_ROWS, 11)
    num = pt.DataFrame(C.host_lists(cols, valid), device=device)
    taq = pt.DataFrame(C.taq_data(N_ROWS, 12), device=device)
    return {"num": num, "taq": taq.with_columns(C.taq_derived(pt))}


def _hosts():
    """_frames' columns as the SCAN bounds read them."""
    cols, valid = C.num_data(N_ROWS, 11)
    return {"num": C.host_columns("num", cols, valid),
            "taq": C.host_columns("taq", C.taq_data(N_ROWS, 12))}


@pytest.fixture(scope="module")
def frames():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {"cuda": _frames("cuda"), "cpu": _frames("cpu"),
            "host": _hosts()}


def _collect(e, frame, hole, device):
    with C.on_device(pt, device), C.quiet():
        return C.query(pt, e, frame, hole).collect()


CASES = [(e.name, False) for e in C.ENTRIES.values()] + \
    [(e.name, False) for e in C.VARIANTS] + \
    [(n, True) for n in C.HOLE_ENTRIES]
_ALL = {**C.ENTRIES, **{e.name: e for e in C.VARIANTS}}


@pytest.mark.parametrize("name,hole", CASES,
                         ids=[f"{n}{'-hole' if h else ''}" for n, h in CASES])
def test_entry_on_the_card_matches_the_cpu(frames, name, hole):
    e = _ALL[name]
    card, cpu = frames["cuda"][e.source], frames["cpu"][e.source]
    if e.family == C.REFUSED:
        with C.on_device(pt, "cuda"):
            got = C.refusal(pt, e, card, hole)
        with C.on_device(pt, "cpu"):
            want = C.refusal(pt, e, cpu, hole)
        assert got == want
        return
    got = C.leaves(_collect(e, card, hole, "cuda"))
    if e.family == C.SAMPLE:
        src = C.Entry(e.name, e.source, C.EXACT,
                      lambda pl: pl.col(e.cols(pl)[0]))
        C.check_sample(e, got, C.leaves(_collect(src, card, hole, "cuda")))
        return
    want = C.leaves(_collect(e, cpu, hole, "cpu"))
    C.compare(e, got, want, C.scan_bound(e, frames["host"][e.source], hole)
              if e.family == C.SCAN else None)
