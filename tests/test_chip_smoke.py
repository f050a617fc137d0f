"""chip_smoke.py's phases at --small size on CPU (the rehearsal the GPU run
is checked against), and its refusal to run without a GPU."""

import dataclasses

import numpy as np
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


@pytest.mark.parametrize("quant", ["i8", "f8"])
def test_phase_edge_flat(ctx, quant):
    out = chip_smoke.phase_edge_flat(ctx, quant)
    assert out["recall"] >= chip_smoke.FLOORS[quant]
    assert min(v for k, v in out.items() if k.startswith("fused_overlap")) >= 0.98


def test_phase_edge_sharded_over_four_devices(ctx):
    out = chip_smoke.phase_sharded(ctx)
    assert out["shard_devices"] == 4
    assert out["recall"] >= chip_smoke.FLOORS["i8"]


def test_phase_served(ctx):
    assert chip_smoke.phase_served(ctx)["recall"] >= chip_smoke.FLOORS["served"]


def test_refuses_to_run_without_a_gpu(capsys):
    assert chip_smoke.main([]) == 1
    assert "no GPU" in capsys.readouterr().err
    assert chip_smoke.main(["--allow-cpu"]) == 2  # rehearsal only


def test_int8_reference_is_exact_integer_arithmetic():
    """The numpy I8 reference: an f32 GEMM of int8 values gives the exact
    integer dots, and it ranks a planted copy of the query first."""
    rng = np.random.default_rng(1)
    codes = rng.integers(-127, 128, (300, 768)).astype(np.int8)
    scale = np.full((300, 1), 0.01, np.float32)
    q = codes[17:18].astype(np.float32) * 0.01
    refs, _ = chip_smoke.int8_reference(codes, scale, q)
    ids, scores = refs[0][0]
    assert ids[0] == 17 and abs(scores[0] - 100.0) < 1e-5
    dots = codes.astype(np.float32) @ codes[17].astype(np.float32)
    np.testing.assert_array_equal(
        dots, codes.astype(np.int64) @ codes[17].astype(np.int64))


def test_int8_reference_admits_both_roundings_of_a_tie():
    """A component at a rounding tie (here 0.5 * 127 / 127) may round
    either way on a device whose division is a few ulp off; the reference
    lists both quantizations, and only that component differs."""
    q = np.array([0.5, 127.0, -3.2], np.float32)
    variants, _ = chip_smoke._admissible_int8(q)
    assert len(variants) == 2
    assert sorted(v[0] for v in variants) == [0.0, 1.0]
    assert all((v[1:] == [127.0, -3.0]).all() for v in variants)
    assert len(chip_smoke._admissible_int8(np.float32([0.3, 127.0]))[0]) == 1
