"""The kernel build's cache key, two processes building at once, and the
profiler's kernel groups, on the CPU: no nvcc runs and no card is
needed."""
import os
import shutil
import subprocess
import sys
import textwrap
import time

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


_FAKE_NVCC = textwrap.dedent("""\
    import sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    print("ptxas info    : Used 1 registers")
    with open(out, "wb") as f:
        for _ in range(64):
            f.write(b"x" * 1024)
            f.flush()
            time.sleep(0.004)
    """)


def test_two_processes_building_at_once_publish_only_whole_libraries(
        csrc_copy, tmp_path, monkeypatch):
    """The driver and the runtime's device worker may build the same
    libraries at once: each writes under a name of its own and publishes
    with os.replace, so a library that exists is always whole (here a
    fake nvcc writes 64 KiB slowly) and both processes end with it."""
    from ray_tpu_torch import _kernels

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + _FAKE_NVCC)
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    monkeypatch.setattr(_kernels, "_BUILD", str(build))
    sos = [_kernels._paths(n)[2] for n in _kernels.SOURCES]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {repo!r})
        from ray_tpu_torch import _kernels as k
        k._CSRC, k._BUILD = {str(csrc_copy)!r}, {str(build)!r}
        k._nvcc = lambda: {str(nvcc)!r}
        k.build_all()
        """)
    procs = [subprocess.Popen([sys.executable, "-c", code])
             for _ in range(2)]
    try:
        deadline = time.monotonic() + 120
        while any(p.poll() is None for p in procs):
            assert time.monotonic() < deadline
            for so in sos:
                if os.path.exists(so):
                    assert os.path.getsize(so) == 64 * 1024, so
            time.sleep(0.001)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0, 0]
    for name in _kernels.SOURCES:
        so = _kernels._paths(name)[2]
        assert os.path.getsize(so) == 64 * 1024
        assert "Used 1 registers" in _kernels.nvcc_log(name)
    left = [f for d in build.iterdir() for f in os.listdir(d)
            if f.endswith(".tmp")]
    assert not left, left


def test_failed_build_leaves_no_files_and_raises_the_log(
        csrc_copy, tmp_path, monkeypatch):
    """nvcc failing for one source raises with its log's tail, after every
    other nvcc has finished, and leaves no temporary file behind."""
    from ray_tpu_torch import _kernels

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + textwrap.dedent("""\
        import sys
        out = sys.argv[sys.argv.index("-o") + 1]
        src = sys.argv[-1]
        if src.endswith("paged_decode.cu"):
            open(out, "wb").write(b"half")
            print("error: paged_decode.cu(1): expected a declaration")
            sys.exit(2)
        print("ptxas info    : Used 1 registers")
        open(out, "wb").write(b"x" * 1024)
        """))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    monkeypatch.setattr(_kernels, "_BUILD", str(build))
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_kernels, "build_seconds", {})
    with pytest.raises(RuntimeError, match="expected a declaration"):
        _kernels.build_all()
    files = sorted(f for d in build.iterdir() for f in os.listdir(d))
    assert not [f for f in files if f.endswith(".tmp")], files
    assert not os.path.exists(_kernels._paths("paged_decode")[2])
    for name in ("flash_fwd", "flash_bwd"):
        assert os.path.getsize(_kernels._paths(name)[2]) == 1024


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
    ("void (anonymous namespace)::flash_bwd_dq_wgmma_kernel<128>(CUtensorMap_"
     "st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
     "float const*, __nv_bfloat16*, int, int, int, int, int, float, float)",
     "flash_bwd_dq"),
    ("void (anonymous namespace)::paged_decode_split_kernel<__nv_bfloat16, "
     "128, 4>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 "
     "const*, __nv_bfloat16 const*, __nv_bfloat16 const*, int const*, int "
     "const*, int const*, __nv_bfloat16*, int, int, int, int, float)",
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
