"""chip_smoke.py's phases at small sizes on the CPU tier, its refusal off
the GPU and its last-line contract. The ``gpu`` tests run the same phases
at full size on the card, in this process."""

import json
import zlib

import jax
import numpy as np
import pytest

import chip_smoke

SIZES = (1, 2, 1000, 4099)


def _rng(*tag):
    return np.random.default_rng(zlib.crc32("/".join(tag).encode()))


@pytest.mark.parametrize("order", chip_smoke.ORDERS)
@pytest.mark.parametrize("dtype", chip_smoke.KEY_DTYPES)
def test_semantics_keys(dtype, order):
    chk = chip_smoke.Checks()
    chip_smoke.case_keys(chk, _rng(dtype, order), dtype, order, SIZES)
    chk.done("keys")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_semantics_float_specials(dtype):
    chk = chip_smoke.Checks()
    chip_smoke.case_float_specials(chk, dtype)
    chk.done("specials")


@pytest.mark.parametrize("case", [
    "case_pairs_stability", "case_u128_payload", "case_windows",
    "case_indices", "case_segmented"])
def test_semantics_cases(case):
    chk = chip_smoke.Checks()
    getattr(chip_smoke, case)(chk, _rng(case), 5003)
    chk.done(case)


def test_semantics_batched():
    chk = chip_smoke.Checks()
    chip_smoke.case_batched(chk, _rng("batched"), rows=8, lengths=(256, 300))
    chk.done("batched")


def test_semantics_errors():
    chk = chip_smoke.Checks()
    chip_smoke.case_errors(chk)
    assert chk.done("errors") == "3 checks bit-exact"


@pytest.mark.parametrize("name", chip_smoke.DTYPES_16)
def test_16bit(name):
    chk = chip_smoke.Checks()
    chip_smoke.case_16bit(chk, _rng(name), name, n=65000)
    chk.done("16-bit")


def test_main_path_small():
    lines = list(chip_smoke.phase_main(soak_n=30011, big_n=1 << 15))
    assert len(lines) == 5
    for line in lines[1:]:
        assert "checks bit-exact" in line and "Gkeys/s" in line, line
    assert "bandwidth bound" in lines[3]


def test_sort_lowering_counts_sorts():
    x = jax.ShapeDtypeStruct((4096,), np.uint32)
    got = chip_smoke.sort_lowering(
        lambda a: chip_smoke.thrs.sort_keys(a), x)
    cub, own = (int(f.split("=")[1]) for f in got.split())
    assert cub + own == 1, got
    seg = chip_smoke.sort_lowering(
        lambda a, s: chip_smoke.thrs.sort_keys(a, segment_ids=s), x,
        jax.ShapeDtypeStruct((4096,), np.int32))
    assert sum(int(f.split("=")[1]) for f in seg.split()) == 2, seg


def test_phase_lowering_names_every_path():
    line = chip_smoke.phase_lowering(n=1 << 12, rows=8)
    assert line.count("cub_radix_sort=") == 7
    assert "psort local lexsort" in line


def test_four_cards_phase_on_cpu_mesh():
    lines = list(chip_smoke.phase_four_cards(n_dryrun=1 << 13,
                                             n_zipf=1 << 15))
    assert lines[0].startswith("dryrun_multichip: 4 scenarios ok")
    assert "psort_keys zipf" in lines[1] and "psort_pairs zipf" in lines[2]


def test_checks_compare_raw_bits():
    chk = chip_smoke.Checks()
    chk.equal("zeros", np.array([-0.0], np.float32), np.array([0.0], np.float32))
    nan_a = np.array([0x7FC00001], np.uint32).view(np.float32)
    nan_b = np.array([0x7FC00002], np.uint32).view(np.float32)
    chk.equal("nan payload", nan_a, nan_b)
    chk.equal("dtype", np.zeros(2, np.int32), np.zeros(2, np.uint32))
    chk.equal("same", nan_a, nan_a.copy())
    assert chk.passed == 1 and len(chk.failed) == 3
    with pytest.raises(AssertionError, match="3 of 4 checks failed"):
        chk.done("x")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_random_keys_hold_every_special(dtype):
    x = chip_smoke.random_keys(np.random.default_rng(1), dtype, 20000)
    u = x.view(f"u{x.dtype.itemsize}")
    sign = np.signbit(x)
    assert np.isnan(x[sign]).any() and np.isnan(x[~sign]).any()
    assert len(np.unique(u[np.isnan(x)])) > 100  # random payloads
    assert np.isinf(x).any() and (u == u.dtype.type(1) << u.dtype.type(
        x.dtype.itemsize * 8 - 1)).any()
    tiny = np.finfo(x.dtype).tiny
    assert ((x != 0) & (np.abs(x) < tiny)).any()  # denormals


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 2
    assert chip_smoke.main(["--four-cards"]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_result_line_contract():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


@pytest.mark.gpu
def test_gpu_semantics(gpu):
    chip_smoke.phase_semantics()


@pytest.mark.gpu
def test_gpu_16bit(gpu):
    chip_smoke.phase_16bit()


@pytest.mark.gpu
def test_gpu_main_path(gpu):
    for line in chip_smoke.phase_main():
        print(line)


@pytest.mark.gpu
def test_gpu_four_cards(gpu):
    if len(jax.devices()) < 4:
        pytest.skip("needs four GPUs")
    for line in chip_smoke.phase_four_cards():
        print(line)
