"""chip_smoke.py's phase functions at tiny sizes on the CPU (the device
check is the only part that needs the card): the same checks against the
host twins that the smoke run makes at the SIFT1M shape."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def pir_engine():
    return chip_smoke.phase_pir(8192, seed=3, batches=2)


def test_phase_pir_checks_offline_state(pir_engine):
    """phase_pir ran every check (tables, parities, replacements, batches)
    at build time of the fixture; the engine is left prepared."""
    eng, raw = pir_engine
    assert eng.state is not None and eng.config.partition_num == 16
    assert raw.shape == (8192, chip_smoke.DIM + chip_smoke.M)


def test_check_prep_detects_a_corrupt_parity(pir_engine):
    eng, raw = pir_engine
    eng.preprocessing(rng=np.random.default_rng(11))
    assert chip_smoke.check_prep(eng, raw, seed=11, n_parity=64)[
        "parity_rows"] == 64
    bad = np.asarray(eng.state["primary_parity"]).copy()
    bad[:, :, 0] ^= 1
    good = eng.state["primary_parity"]
    eng.state["primary_parity"] = bad
    try:
        with pytest.raises(chip_smoke.SmokeFailure, match="parity"):
            chip_smoke.check_prep(eng, raw, seed=11, n_parity=64)
    finally:
        eng.state["primary_parity"] = good


def test_check_prep_detects_wrong_keys(pir_engine):
    eng, raw = pir_engine
    eng.preprocessing(rng=np.random.default_rng(12))
    with pytest.raises(chip_smoke.SmokeFailure, match="PRF tables"):
        chip_smoke.check_prep(eng, raw, seed=13)


def test_serve_batches_exact(pir_engine):
    eng, raw = pir_engine
    eng.preprocessing(rng=np.random.default_rng(14))
    ms, success = chip_smoke.serve_batches(eng, raw, 8192, seed=2, batches=2)
    assert ms > 0 and success >= 0.98


def test_phase_fused_matches_bound_and_split_route(pir_engine):
    eng, raw = pir_engine
    res = chip_smoke.phase_fused(eng, raw, 8192, seed=4, groups=(1, 2),
                                 reps=1)
    for g in (1, 2):
        assert abs(res[g]["fetch_success"] - res[g]["bound"]) <= 0.02
        assert res[g]["routes_agree"] >= 0.995


def test_answers_agree():
    a = np.array([[1, 2, 3, 4], [5, 6, 7, 8]])
    assert chip_smoke.answers_agree(a, a) == 1.0
    b = np.array([[1, 2, 3, 9], [5, 6, 7, 8]])
    assert chip_smoke.answers_agree(a, b) == pytest.approx(0.875)


def test_phase_graph_recall_contract():
    res = chip_smoke.phase_graph(2048, seed=1, n_queries=40, rounds=4,
                                 concurrent=8, min_recall=0.8)
    assert abs(res["recall_device"] - res["recall_host"]) <= 0.02
    assert abs(res["recall_private"] - res["recall_device"]) <= 0.02


def test_phase_four_on_cpu_mesh():
    import jax

    assert jax.device_count() >= 4
    chip_smoke.phase_four(8192, seed=6, n_chunk=4096, devices=4, batches=2,
                          group=1)


def test_device_phase_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.phase_device(1)
    assert e.value.code == 2
    assert "needs 1 GPU" in capsys.readouterr().err
