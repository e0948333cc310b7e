"""The kernel build's SASS evidence (``kernels/build.py::sass_counts``) on
the CPU: a missing cuobjdump fails rather than skips, and the counts are
of whole mnemonics (HGMMA.64x128x16... counts as HGMMA, IGMMA for the
int8 wgmma, HMMA for mma.sync). On the card,
chip_smoke.py runs it on every built library.
"""
import os
import stat

import pytest

from video_depth_anything_torch.kernels import build


def _fake_toolkit(tmp_path, sass: str | None):
    """A directory with an nvcc and, if sass is given, a cuobjdump that
    prints it."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nexit 0\n")
    os.chmod(nvcc, stat.S_IRWXU)
    if sass is not None:
        (tmp_path / "sass.txt").write_text(sass)
        tool = tmp_path / "cuobjdump"
        tool.write_text(f"#!/bin/sh\ncat {tmp_path / 'sass.txt'}\n")
        os.chmod(tool, stat.S_IRWXU)
    return str(nvcc)


def test_sass_counts_fail_without_cuobjdump(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_toolkit(tmp_path, None))
    with pytest.raises(build.KernelBuildError, match="cuobjdump"):
        build.sass_counts("fused_rcu")


def test_sass_counts_count_mnemonics(tmp_path, monkeypatch):
    sass = "\n".join([
        "        /*0100*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;",
        "        /*0110*/  HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;",
        "        /*0120*/  UTMALDG.4D [UR8], [UR16] ;",
        "        /*0130*/  UTMALDG.2D.MULTICAST [UR16], [UR54], UR20 ;",
        "        /*0140*/  SYNCS.EXCH.64 URZ, [UR4], UR6 ;",
        "        /*0150*/  SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [R3], RZ ;",
        "        /*0160*/  SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R3], R2 ;",
        "        /*0170*/  WARPGROUP.DEPBAR.LE gsb0, 0x0 ;",
        "        /*0180*/  LDSM.16.M88.4 R4, [R2] ;",
        "        /*0190*/  IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], RZ, !UPT ;",
        "        /*01a0*/  HMMA.16816.F32.BF16 R8, R12, R16, R8 ;",
        "        /*01b0*/  HMMA.1688.F32.BF16 R4, R20, R22, R4 ;"])
    monkeypatch.setattr(build, "_nvcc", lambda: _fake_toolkit(tmp_path, sass))
    monkeypatch.setattr(build, "build_all", lambda: {})
    assert build.sass_counts("fused_rcu") == {"HGMMA": 2, "IGMMA": 1, "HMMA": 2, "UTMALDG": 2,
                                              "SYNCS": 3}
