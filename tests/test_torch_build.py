"""The build of the port's kernel library (``apex_tpu_torch/_build.py``),
checked without ``nvcc``: what its digest covers, and what it compiles
with which flags."""

import ctypes
import shutil
import subprocess

import pytest

from apex_tpu_torch import _build
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``_build`` reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_digest_changes_with_a_header(csrc_copy):
    """An edit to a shared header must rebuild the library, as an edit to
    a source does: the digest covers every ``*.cu`` and ``*.cuh``."""
    header = csrc_copy / "attention_core.cuh"
    assert header.exists()
    before = _build._digest()
    assert _build._digest() == before
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = _build._digest()
    assert after_header != before
    source = csrc_copy / "paged_attention.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert _build._digest() not in (before, after_header)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build._digest() not in (before, after_header)


def test_every_source_compiles_with_the_header_directory(csrc_copy,
                                                          tmp_path,
                                                          monkeypatch):
    """Each ``*.cu`` gets its own ``nvcc -I csrc -c`` (headers are not
    compiled alone), and a failed compile raises with every log."""
    calls = []

    class FailedCompile:
        returncode = 1

        def __init__(self, cmd, **_):
            calls.append(cmd)

        def communicate(self):
            return "error: stand-in compiler", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FailedCompile)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    compiled = sorted(cmd[cmd.index("-c") + 1] for cmd in calls)
    assert compiled == sorted(str(p) for p in csrc_copy.glob("*.cu"))
    assert "attention_core.cuh" not in " ".join(compiled)
    for cmd in calls:
        assert cmd[cmd.index("-I") + 1] == str(csrc_copy)
        assert "arch=compute_90a,code=sm_90a" in cmd


def test_the_tensor_core_entry_points_are_bound():
    """Every tensor-core launcher and its shared-memory query have ctypes
    signatures, beside the kernels they sit next to."""
    sig = _build._SIGNATURES
    for name in ("apex_flash_fwd_tc", "apex_paged_prefill_tc",
                 "apex_flash_dq_tc", "apex_flash_dkv_tc",
                 "apex_flash_fwd_tc_smem", "apex_paged_prefill_tc_smem",
                 "apex_flash_dq_tc_smem", "apex_flash_dkv_tc_smem"):
        assert name in sig
    # the tc launchers take the simt ones' operands less q's dtype (K2's
    # trades the simt query tile for the arena's block count)
    for kernel in ("fwd", "dq", "dkv"):
        assert sig[f"apex_flash_{kernel}_tc"] == sig[f"apex_flash_{kernel}"][1:]
        assert sig[f"apex_flash_{kernel}_tc_smem"] == [ctypes.c_int]
    assert sig["apex_paged_prefill_tc"] == sig[
        "apex_paged_attention_prefill"][1:]


def test_the_split_decode_entry_points_are_bound():
    """K1's split route: the launcher takes the first decode launcher's
    operands less q's dtype (the route is bf16 q only), plus the partials
    and tickets before ``out`` and the number of splits after the table
    width; the splits query takes the table's cache positions."""
    sig = _build._SIGNATURES
    simt = sig["apex_paged_attention_decode"]
    split = sig["apex_paged_decode_split"]
    p = ctypes.c_void_p
    assert split == simt[1:9] + [p, p, p] + simt[10:16] + [ctypes.c_int] + simt[16:]
    assert sig["apex_paged_decode_splits"] == [ctypes.c_int]
    assert split[-2:] == [ctypes.c_float, p]


def test_the_cluster_lora_entry_point_is_bound():
    """L1's cluster route: its launcher takes the first L1 launcher's
    operands, dtype codes, sizes and strides, in the same order; the row
    norms keep their one launcher."""
    sig = _build._SIGNATURES
    assert sig["apex_lora_delta_cluster"] == sig["apex_lora_delta"]
    assert sig["apex_lora_delta"][-3:] == [ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_void_p]
    assert [name for name in sig if "row_norm" in name] == ["apex_row_norm"]


def test_the_residual_norm_entry_point_is_bound():
    """K3's launcher takes the dtype codes of x, the residual and the
    parameters, then its seven operands (x, residual, skip bias, weight,
    bias_ln, normed, new residual), the rows, the hidden size, eps and the
    stream."""
    p, i = ctypes.c_void_p, ctypes.c_int
    assert _build._SIGNATURES["apex_fused_residual_norm"] == (
        [i, i, i] + [p] * 7 + [i, i, ctypes.c_float, p])
