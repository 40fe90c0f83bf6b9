"""The control on the card: the reference computed in TF32 (the precision
next below the configurations' f32 with TF32 off), put in the program's
place, comes out not correct against each one-card cell's limits, at a
size a test run holds. ``h100bench/control.py`` reads the same at the
cells' own sizes."""

import time

import pytest
import torch

from h100bench import harness

SMALL = {"car_model.online_fast": {"streams": 16, "keep": 1,
                                   "ref_block": 16},
         "config3_multiscale.decode_b64": {"pairs": 8, "distinct_batches": 2,
                                           "keep": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_control_is_not_correct(name, seed, card):
    cell = harness.Cell(name)
    mix = dict(cell.mix, **SMALL[name])
    out = harness.run_cell(cell, seed, 1.0, False, [card],
                           time.perf_counter(), control=True, mix=mix,
                           log=lambda s: None)
    ok, rows = harness.verdict(out["compared"], cell.limits)
    assert ok, rows
    bad, rows = harness.verdict(out["control"], cell.limits)
    assert not bad, rows
    torch.cuda.empty_cache()
