"""The port's roofline table and quantized-KV gate
(src/repro_torch/launch/roofline.py) against the reference's
(benchmarks/roofline.py): the flash-attention traffic and FLOP helpers
and the quant roofline equal over a grid of shapes, the gate passes at
the card's ridge, and the report reader and row format equal the
reference's over the same reports."""
import contextlib
import io
import itertools
import json
import sys

import pytest

from benchmarks import roofline as RR
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import roofline as PR

GRID = list(itertools.product((1, 2), (4, 32), (1, 128, 1000), (64, 1024),
                              (32, 128)))


@pytest.mark.parametrize("B,H,S,Sk,hd", GRID)
def test_flash_helpers_equal_reference(B, H, S, Sk, hd):
    assert PR.flash_flops(B, H, S, Sk, hd) == RR.flash_flops(B, H, S, Sk, hd)
    for q_bytes, kv_bytes, scaled, block_q in ((2, 2, False, 128),
                                               (4, 1, True, 64),
                                               (2, 1, True, 256)):
        kw = dict(q_bytes=q_bytes, kv_bytes=kv_bytes, scaled=scaled,
                  block_q=block_q)
        assert (PR.flash_traffic_bytes(B, H, S, Sk, hd, **kw)
                == RR.flash_traffic_bytes(B, H, S, Sk, hd, **kw))
    for native in (2, 4):
        assert (PR.quant_attention_roofline(B, H, S, Sk, hd, native)
                == RR.quant_attention_roofline(B, H, S, Sk, hd, native))


def test_quant_gate_passes_at_the_card_ridge():
    hw = CA.hardware("cpu")
    assert PR.RIDGE_FLOPS_PER_BYTE == hw["peak_flops"] / hw["hbm_bw"]
    assert 295 < PR.RIDGE_FLOPS_PER_BYTE < 296
    assert PR.KV_SCALE_BYTES == RR.KV_SCALE_BYTES
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert PR.check_quant_rooflines() == 0
        assert PR.main(["--quant"]) == 0
    assert "FAIL" not in out.getvalue()
    assert RR.check_quant_rooflines(verbose=False) == 0


def _rf(c, m, x):
    return {"flops": 1.0, "hbm_bytes": 2.0, "coll_bytes": 3.0,
            "coll_breakdown": {}, "compute_s": c, "memory_s": m,
            "collective_s": x, "dominant": max(
                {"compute": c, "memory": m, "collective": x}.items(),
                key=lambda kv: kv[1])[0], "useful_ratio": 0.37}


REPORTS = {
    "yi-9b__decode_32k__16x16.json": {
        "arch": "yi-9b", "shape": "decode_32k", "mesh": "16x16",
        "status": "ok", "roofline": _rf(1e-4, 5e-3, 2e-4)},
    "yi-9b__long_500k__16x16.json": {
        "arch": "yi-9b", "shape": "long_500k", "mesh": "16x16",
        "status": "skip",
        "reason": "full-attention arch: 500k ctx needs sub-quadratic attn"},
    "mamba2-370m__train_4k__16x16.json": {
        "arch": "mamba2-370m", "shape": "train_4k", "mesh": "16x16",
        "status": "fail", "error": "boom"},
    "whisper-tiny__decode_32k__2x16x16.json": {
        "arch": "whisper-tiny", "shape": "decode_32k", "mesh": "2x16x16",
        "status": "ok"},
    "olmoe-1b-7b__train_4k__16x16__ep2d.json": {
        "arch": "olmoe-1b-7b", "shape": "train_4k", "mesh": "16x16",
        "status": "ok", "roofline": _rf(3.0, 1.0, 0.5)},
}


@pytest.fixture
def reports(tmp_path, monkeypatch):
    for name, rep in REPORTS.items():
        (tmp_path / name).write_text(json.dumps(rep))
    monkeypatch.setattr(PR, "REPORT_DIR", tmp_path)
    monkeypatch.setattr(RR, "REPORT_DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("mesh,opt", [("16x16", None), ("2x16x16", None),
                                      ("16x16", "ep2d"), ("4x4", None)])
def test_load_reports_and_rows_equal_reference(reports, mesh, opt):
    got, want = PR.load_reports(mesh, opt), RR.load_reports(mesh, opt)
    assert got == want
    assert [PR.fmt_row(r) for r in got] == [RR.fmt_row(r) for r in want]
    assert len(got) == {("16x16", None): 3, ("2x16x16", None): 1,
                        ("16x16", "ep2d"): 1, ("4x4", None): 0}[mesh, opt]


@pytest.mark.parametrize("flags", [["--csv"], [], ["--mesh", "2x16x16"]])
def test_main_prints_the_reference_table(reports, monkeypatch, flags):
    def run(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(argv)
        return out.getvalue().splitlines()

    def ref_main(argv):
        monkeypatch.setattr(sys, "argv", ["roofline"] + argv)
        RR.main()
    got, want = run(PR.main, flags), run(ref_main, flags)
    # the header names the port's interconnect (NVLink) for the v5e's ICI
    if flags != ["--csv"]:
        assert got[0] == want[0].replace("ICI", "NVLink")
        got, want = got[1:], want[1:]
    assert got == want and got
