"""``chip_smoke.Compare``, the parity phase's checker, against a field-by-field
reading of its own rule on the CPU.

``Compare`` keeps its sums and maxima on the device and compares each dtype's
float fields as one concatenated block; the reference here walks the fields
one at a time with host reads, as the rule in its docstring reads.  Every
figure must be equal; the worst field may differ only where two fields tie.
"""

from __future__ import annotations

import os
import random
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def reference(rtol, rtol_of, calls):
    """The rule, field by field: bad lane-calls, bad ones by field, the
    largest |kernel - plain| and the largest scaled error."""
    bad_total, by_field, max_abs, max_scaled = 0, {}, 0.0, 0.0
    for b, ints, floats in calls:
        lane_bad = torch.zeros(b, dtype=torch.bool)
        for name, (k, p) in ints.items():
            bad = (k.reshape(b, -1) != p.reshape(b, -1)).any(1)
            by_field[name] = by_field.get(name, 0) + int(bad.sum())
            lane_bad |= bad
        for name, (k, p, vector) in floats.items():
            k, p = k.reshape(b, -1), p.reshape(b, -1)
            same_nonfinite = ((k.isnan() == p.isnan()).all(1)
                              & ((k.isinf() & (k == p)) == p.isinf()).all(1))
            fin = p.isfinite() & k.isfinite()
            diff = torch.where(fin, (k - p).abs(), torch.zeros_like(p))
            mag = torch.where(fin, p.abs(), torch.zeros_like(p))
            scale = mag.amax(1, keepdim=True) if vector else mag
            scaled = diff / scale.clamp_min(torch.finfo(p.dtype).tiny)
            scaled = torch.where(diff == 0, torch.zeros_like(diff), scaled)
            bad = ~same_nonfinite | (scaled > rtol_of.get(name, rtol)).any(1)
            by_field[name] = by_field.get(name, 0) + int(bad.sum())
            lane_bad |= bad
            max_abs = max(max_abs, float(diff.max()))
            max_scaled = max(max_scaled, float(scaled.max()))
        bad_total += int(lane_bad.sum())
    return {"mismatched_lane_calls": bad_total,
            "mismatched_by_field": {k: v for k, v in by_field.items() if v},
            "max_abs_err": max_abs, "max_scaled_err": max_scaled}


def made_up_pair(rng, shape, dtype, kind):
    p = torch.randn(shape, dtype=dtype) * 10.0 ** rng.randint(-3, 3)
    k = p.clone()
    if kind in ("off", "nonfinite"):
        k += (torch.randn(shape, dtype=dtype) * p.abs().mean()
              * 10.0 ** rng.uniform(-12, -2))
    if kind == "nonfinite":
        k[torch.rand(shape) < 0.05] = float("nan")
        p[torch.rand(shape) < 0.05] = rng.choice((float("inf"),
                                                  float("nan")))
        both = torch.rand(shape) < 0.03
        k[both] = p[both] = float("-inf")
    if kind == "zero_scale":
        p.zero_()
        k.zero_()
        k.view(-1)[0] = 1e-30
    return k, p


@pytest.mark.parametrize("seed", range(12))
def test_compare_matches_field_by_field_rule(seed):
    rng = random.Random(seed)
    torch.manual_seed(seed)
    rtol = rng.choice((1e-9, 1e-5))
    rtol_of = {"f1": 1e-4} if seed % 2 else {}
    cmp = chip_smoke.Compare(rtol, rtol_of)
    calls = []
    b = rng.choice((1, 3, 8))
    for _ in range(rng.randint(1, 4)):
        ints = {}
        for i in range(rng.randint(1, 3)):
            width = (rng.randint(1, 4),) if rng.random() < 0.5 else ()
            p = torch.randint(0, 3, (b,) + width,
                              dtype=rng.choice((torch.int32, torch.int64)))
            k = p.clone()
            if rng.random() < 0.3:
                k.view(-1)[0] += 1
            ints[f"i{i}"] = (k, p)
        floats = {}
        for i in range(rng.randint(0, 4)):
            width = (rng.randint(1, 20),) if rng.random() < 0.7 else ()
            floats[f"f{i}"] = (*made_up_pair(
                rng, (b,) + width, rng.choice((torch.float32, torch.float64)),
                rng.choice(("equal", "off", "nonfinite", "zero_scale"))),
                rng.random() < 0.6)
        cmp.add(b, ints, floats)
        calls.append((b, ints, floats))
    got = cmp.result(launches=len(calls))
    want = reference(rtol, rtol_of, calls)
    for key, value in want.items():
        assert got[key] == value, key
    assert got["calls"] == len(calls)
    assert got["lane_calls"] == b * len(calls)
    assert got["launches"] == len(calls)
    assert (got["worst_field"] == "") == (got["max_scaled_err"] == 0.0)
