"""The GPU-only scripts refuse to report numbers from another device."""

import pytest

import bench
import chip_smoke


def test_bench_peak_table_knows_the_h100():
    assert bench.device_peak_bw("NVIDIA H100 80GB HBM3") == 3.35e12


def test_bench_peak_table_raises_on_unknown_device():
    with pytest.raises(ValueError, match="no data-sheet bandwidth"):
        bench.device_peak_bw("cpu")


def test_chip_smoke_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert "no GPU found" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out
