"""The benchmark's own arithmetic against hand-worked cases."""
import json

import numpy as np
import pytest
import torch

from portbench import reference, trace, yardstick
from portbench.tests.tiny import REPO

SMALL = {"rows": [5, 7, 3], "embed_dim": 4, "n_dense": 2, "bottom_mlp": [3], "top_mlp": [5],
         "dtype": "float32"}


def test_step_flops_by_hand():
    # bottom 2-3-4, top (4 + C(4, 2) = 10)-5-1: 2*3 + 3*4 + 10*5 + 5*1 = 73
    # multiply-adds a sample, and the Gram product 4 * 4 * 4 = 64
    assert yardstick.step_flops(SMALL, 10) == 2 * 10 * (73 + 64)


@pytest.mark.parametrize("name,per_sample", [("dlrm-taobao", 720_384), ("dlrm-tenrec", 649_504)])
def test_step_flops_of_the_configurations(name, per_sample):
    cfg = json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
    assert yardstick.step_flops(cfg, 1) == per_sample


def test_lookup_and_step_bytes_by_hand():
    idx = np.array([[[0], [0], [4]], [[6], [1], [6]], [[2], [2], [2]]], np.int32)  # (3, 3, 1)
    assert yardstick.distinct_rows(idx) == 2 + 2 + 1
    # indices 9 * 4, five rows of 16 bytes, output 3 * 3 * 4 * 4
    assert yardstick.lookup_bytes(SMALL, idx) == 36 + 80 + 144
    params = (2 * 3 + 3) + (3 * 4 + 4) + (10 * 5 + 5) + (5 * 1 + 1)
    # indices, dense 3 * 2 * 4, weights, rows, logits 3 * 4
    assert yardstick.step_bytes(SMALL, idx) == 36 + 24 + params * 4 + 80 + 12


def test_bound_picks_the_larger_time():
    ms, what = yardstick.bound(3.35e9, 1.0)
    assert what == "bytes" and ms == pytest.approx(1.0)
    ms, what = yardstick.bound(0.0, 67e9)
    assert what == "operations" and ms == pytest.approx(1.0)


def test_busy_and_gaps_by_hand():
    busy, window, gaps = trace.busy_and_gaps([(0, 2), (1, 3), (5, 6), (6, 8), (10, 11)])
    assert (busy, window) == (7, 11)
    assert gaps == [(3, 5), (8, 10)]
    assert trace.busy_and_gaps([]) == (0.0, 0.0, [])


@pytest.mark.parametrize("n", [1, 2, 11, 16])
def test_pair_order_is_the_upper_triangle_row_by_row(n):
    iu, ju = reference.pairs(n)
    want = torch.triu_indices(n, n, offset=1)
    assert iu == want[0].tolist() and ju == want[1].tolist()


def test_reference_pools_and_scores_by_hand():
    tables = [torch.arange(8.0).view(4, 2), torch.ones(3, 2)]
    idx = torch.tensor([[[1, -1]], [[0, 2]]])  # (2, 1, 2)
    emb = reference.pooled(tables, idx)
    assert emb.tolist() == [[[2.0, 3.0]], [[2.0, 2.0]]]
    eye = torch.eye(2)
    mlp = {"bottom": [(eye, torch.zeros(2))], "top": [(torch.ones(5, 1), torch.zeros(1))]}
    dense = torch.tensor([[1.0, -1.0]])
    # bottom: relu([1, -1]) = [1, 0]; pairs (0,1) 2, (0,2) 2, (1,2) 4 + 6 = 10
    assert reference.logits(mlp, dense, emb).tolist() == [1.0 + 0.0 + 2.0 + 2.0 + 10.0]
