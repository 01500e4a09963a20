"""The port's measurement entry points (``tools/microbench.py``,
``tools/probes.py``) run end to end on the CPU at their ``--small`` shapes:
one well-formed JSON line per section, every record naming the CPU and the
host clock, the same records in ``<out-dir>/<name>.jsonl``, and every record
of a port kernel held against its plain version (status OK, with its error,
its stated tolerance, the plain version's time and its bound). Without ``--device
cpu`` and without a GPU they raise instead of running on the CPU."""

import json
import math

import numpy as np
import pytest
import torch

from pytorch_connectomics_tpu_torch.ops.probes import lane_shift_plain
from pytorch_connectomics_tpu_torch.tools import microbench, probes

MICROBENCH = ["matmul_256_bf16", "dw3_8c32", "dw3_4c64", "dw3_4c128", "dw3_2c256", "dw3_2c512", "pw_pair_8c32",
              "fused_mlp_8c32", "gn_8c32", "mednext_s_fwd_b1", "vpu_fma27_bf16"]
PROBES = ["fma_chain_f32_8x128", "fma_chain_bf16_8x128", "fma_chain_f32_64x128", "fma_chain_bf16_64x128",
          "dw_stencil_f32", "dw_stencil_bf16", "E1_copy", "E1_roll5", "E1_slice128", "E1_scratch_roll1",
          "E1b_shift_f32", "E1b_shift_bf16", "copy_small_bf16", "roll5_small_bf16", "E2_f32", "E2_bf16", "E3_pw_f32", "E3_pw_bf16"]


@pytest.mark.parametrize("tool,names", [(microbench, MICROBENCH), (probes, PROBES)], ids=["microbench", "probes"])
def test_tool_prints_every_section(tool, names, tmp_path, capsys):
    records = tool.main(["--device", "cpu", "--small", "--out-dir", str(tmp_path)])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert lines == records
    assert [r["name"] for r in records] == names
    saved = [json.loads(line) for line in (tmp_path / f"{tool.__name__.rsplit('.', 1)[1]}.jsonl").read_text().splitlines()]
    assert saved == records
    for r in records:
        assert r["device"] == "cpu" and r["clock"] == "host"
        assert math.isfinite(r["ms"]) and r["ms"] > 0
        for key in ("tflops", "GBps", "tfma_s", "tmac_s", "mvox_s", "library_ms"):
            if key in r:
                assert math.isfinite(r[key]) and r[key] > 0, (r["name"], key)
        assert r.get("status", "OK") == "OK", r
        if "kernel" in r:
            assert r["status"] == "OK" and r["tol"] and r["bound_by"] in ("bytes", "operations"), r
            assert r["max_abs_err"] == 0.0, r  # on the CPU the wrapper runs the plain version itself
            for key in ("plain_ms", "bound_ms"):
                assert math.isfinite(r[key]) and r[key] > 0, (r["name"], key)
        if r["name"].startswith("E1"):  # the data-movement probes: the library call and both host times
            assert r["library"] == ("Tensor.clone" if r["offset"] == 0 else "torch.roll" if r["circular"] else "F.pad")
            for key in ("library_ms", "host_us", "library_host_us"):
                assert math.isfinite(r[key]) and r[key] > 0, (r["name"], key)
    if tool is probes:
        by_name = {r["name"]: r for r in records}
        assert [by_name[n]["library"] for n in ("E1_slice128", "E1b_shift_f32", "E1b_shift_bf16")] == ["F.pad"] * 3
        roll = by_name["roll5_small_bf16"]
        assert (roll["offset"], roll["circular"], roll["library"]) == (5, True, "torch.roll") and roll["GBps"] > 0


def test_tools_refuse_to_run_on_cpu_unasked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for tool in (microbench, probes):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--small", "--out-dir", str(tmp_path)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("lanes", [384, 37])
def test_zero_shift_library_is_the_zero_filled_shift(dtype, lanes):
    """``F.pad`` of a slice (the scripts' ``jnp.pad(a[:, k:])`` and its
    mirror) computes ``lane_shift``'s zero-filled shift: the library call the
    zero-filled E1 records are timed against."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((3, lanes), dtype=np.float32)).to(dtype)
    for k in (1, -1, 128, -128, 0, lanes, -lanes):
        assert torch.equal(probes.zero_shift(x, k), lane_shift_plain(x, k, False)), k
        name, call = probes.shift_library(x, k, False)
        assert name == ("Tensor.clone" if k == 0 else "F.pad") and torch.equal(call(), lane_shift_plain(x, k, False))
