"""The kernel build's cache key and the profiler's kernel groups, on the
CPU: no nvcc runs and no card is needed."""
import shutil

import pytest


@pytest.fixture
def csrc_copy(monkeypatch, tmp_path):
    """The package's csrc/ copied to a temporary directory that the build
    reads instead."""
    from ray_tpu_torch import _kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels._CSRC, csrc)
    monkeypatch.setattr(_kernels, "_CSRC", str(csrc))
    return csrc


def _build_dirs():
    from ray_tpu_torch import _kernels

    return {n: _kernels._paths(n)[1] for n in _kernels.SOURCES}


def test_edited_shared_header_changes_every_build_directory(csrc_copy):
    """A shared header (csrc/*.cuh) is part of every library's key, so an
    edit to the wgmma/TMA helpers never loads a stale library."""
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert [h.name for h in headers] == ["hopper.cuh"]
    before = _build_dirs()
    assert _build_dirs() == before                  # the key is stable
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = _build_dirs()
    assert all(after[n] != before[n] for n in before)


def test_new_header_changes_the_key(csrc_copy):
    before = _build_dirs()
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    after = _build_dirs()
    assert all(after[n] != before[n] for n in before)


def test_edited_source_changes_only_its_own_key(csrc_copy):
    before = _build_dirs()
    src = csrc_copy / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _build_dirs()
    assert after["flash_fwd"] != before["flash_fwd"]
    assert {n: d for n, d in after.items() if n != "flash_fwd"} == \
        {n: d for n, d in before.items() if n != "flash_fwd"}


# Kernel names as torch.profiler reports them on the card.
_NAMES = [
    ("void (anonymous namespace)::flash_fwd_wgmma_kernel<128>(CUtensorMap_st"
     ", CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, float*, int, int, "
     "int, int, int, float)", "flash_fwd"),
    ("void (anonymous namespace)::flash_fwd_kernel<float, 32>(float const*, "
     "float const*, float const*, float*, float*, int, int, int, int, int, "
     "float)", "flash_fwd"),
    ("void (anonymous namespace)::flash_bwd_dkv_wgmma_kernel<64>(CUtensorMap"
     "_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
     "float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, int, int, int,"
     " float, float)", "flash_bwd_dkv"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<float, 128>(float "
     "const*, float const*, float const*, float const*, float const*, float "
     "const*, float*, float*, int, int, int, int, int, float)",
     "flash_bwd_dkv"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16, 128>("
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, float const*, float const*, __nv_bfloat16*, int,"
     " int, int, int, int, float)", "flash_bwd_dq"),
    ("void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, 128>()",
     "paged_decode"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "BinaryFunctor<float, float, float>>", "other"),
]


@pytest.mark.parametrize("name,group", _NAMES)
def test_kernel_group(name, group):
    """Both dtype routes of the forward and dK/dV land in their flash
    group; a wgmma kernel never counts as a library GEMM."""
    from ray_tpu_torch.tools.profile_serve import kernel_group

    assert kernel_group(name) == group
