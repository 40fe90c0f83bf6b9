"""The comparison catches a broken timed path: each fault a cell can have,
planted under a tiny CPU run of the harness (its look for a card skipped),
turns ``correct`` false against the cell's limits."""

import math
import time

import pytest
import torch

from h100bench import harness


def run_faulty(name, mixes, seed=11):
    cell = harness.Cell(name)
    mix = dict(cell.mix, **mixes[name])
    torch.set_num_threads(2)
    out = harness.run_cell(cell, seed, 0.2, False, ["cpu"] * cell.chips,
                           time.perf_counter(), mix=mix, log=lambda s: None)
    ok, rows = harness.verdict(out["compared"], cell.limits)
    return ok, rows


def _state_unchanged(monkeypatch):
    """The step leaves the stream state where reset put it."""
    from depth_estimation_tpu_torch import api_batched
    fn = api_batched.BatchedDepthEstimator.next_frames
    names = ("last_u", "last_feats")

    def stuck(self, *a, **k):
        saved = [getattr(self, n) for n in names]
        out = fn(self, *a, **k)
        for n, v in zip(names, saved):
            setattr(self, n, v)
        return out
    monkeypatch.setattr(api_batched.BatchedDepthEstimator, "next_frames",
                        stuck)


def _half_batch(monkeypatch):
    """Half of the streams left out: they get the mean of the rest."""
    from depth_estimation_tpu_torch import api_batched
    fn = api_batched.BatchedDepthEstimator.next_frames

    def half(self, frames):
        outs = list(fn(self, frames))
        h = outs[0].shape[0] // 2
        for i in range(3):
            outs[i] = outs[i].clone()
            outs[i][h:] = outs[i][:h].mean(0, keepdim=True)
        return tuple(outs)
    monkeypatch.setattr(api_batched.BatchedDepthEstimator, "next_frames",
                        half)


def _altered_flow(monkeypatch):
    """Each stream's x-flow answer at the middle pixel moved by 5 px where
    B1 produces it."""
    from depth_estimation_tpu_torch.ops import matching
    fused = matching.match_flow_fused

    def off(*a, **k):
        outs = list(fused(*a, **k))
        ex = outs[2].clone()
        ex[..., ex.shape[-2] // 2, ex.shape[-1] // 2] += 5.0
        outs[2] = ex
        return tuple(outs)
    monkeypatch.setattr(matching, "match_flow_fused", off)


def _open_gate(monkeypatch):
    """B1's confidence gate turned round where B1 produces it: the pixels
    it rejects pass and those it passes are rejected."""
    from depth_estimation_tpu_torch.ops import matching
    fused = matching.match_flow_fused

    def flipped(*a, **k):
        outs = list(fused(*a, **k))
        outs[4] = 1.0 - outs[4]
        return tuple(outs)
    monkeypatch.setattr(matching, "match_flow_fused", flipped)


def _turned_rotation(monkeypatch):
    """Ego-motion's R turned 0.012 rad about the optical axis where it is
    produced: under 2 px of flow at the frame's edge, so R's own gap must
    catch it."""
    from depth_estimation_tpu_torch.geometry3d import egomotion
    ego = egomotion.get_ego_motion_batched
    c, s = math.cos(0.012), math.sin(0.012)

    def turned(*a, **k):
        em = ego(*a, **k)
        Rz = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                          device=em.R.device)
        return em._replace(R=Rz @ em.R)
    monkeypatch.setattr(egomotion, "get_ego_motion_batched", turned)


def _altered_cost(monkeypatch):
    """One cost of the multiscale SSD volume lowered where match_ssd
    produces it, so that its cell wins the pixel."""
    from depth_estimation_tpu_torch.ops import matching
    ssd = matching.match_ssd

    def off(*a, **k):
        c = ssd(*a, **k).clone()
        c.view(-1, c.shape[-1])[c.numel() // (2 * c.shape[-1]), 0] -= 1e3
        return c
    monkeypatch.setattr(matching, "match_ssd", off)


CASES = [("car_model.online_fast", _state_unchanged),
         ("car_model.online_fast", _half_batch),
         ("car_model.online_fast", _altered_flow),
         ("car_model.online_fast", _open_gate),
         ("car_model.online_fast", _turned_rotation),
         ("config3_multiscale.decode_b64", _altered_cost)]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in CASES])
def test_fault_is_not_correct(name, fault, tiny_mixes, monkeypatch):
    fault(monkeypatch)
    ok, rows = run_faulty(name, tiny_mixes)
    assert not ok, rows
