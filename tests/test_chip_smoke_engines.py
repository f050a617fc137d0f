"""chip_smoke.py's PQ/BQ, HNSW and CFLAT phases at --small size on CPU
(split from test_chip_smoke.py so the two files run on separate workers)."""

import dataclasses

import pytest

import chip_smoke


@pytest.fixture
def ctx(tmp_path):
    args = chip_smoke.parse_args(["--small", "--allow-cpu", "--seed", "0"])
    # below the rehearsal sizes (recall only rises as N falls, so the
    # floors still hold) to keep the suite fast
    sizes = dataclasses.replace(chip_smoke.SMALL, pqbq_n=8192, hnsw_n=8192,
                                served_n=4096)
    return chip_smoke.Ctx(args, sizes, False, str(tmp_path))


def test_phase_edge_pq_bq(ctx):
    out = chip_smoke.phase_edge_pq_bq(ctx)
    assert out["recall_pq"] >= chip_smoke.FLOORS["pq"]
    assert out["recall_bq"] >= chip_smoke.FLOORS["bq"]


def test_phase_core_hnsw(ctx):
    out = chip_smoke.phase_core_hnsw(ctx)
    assert out["recall_replay"] >= chip_smoke.FLOORS["hnsw"]


def test_phase_cflat(ctx):
    assert chip_smoke.phase_cflat(ctx)["recall"] >= chip_smoke.FLOORS["cflat"]
