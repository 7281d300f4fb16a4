"""The kernel build's library names: a library is named by a hash of its
source, every ``csrc/*.cuh`` header and the compiler flags, so editing a
header the sources include rebuilds them instead of loading a stale
library.  No ``nvcc`` is needed: only the names are computed."""

from repro_torch.kernels import build


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "hopper.cuh"\nextern "C" int k() { return 0; }\n')
    (csrc / "hopper.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_editing_a_header_changes_the_library_path(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = build._lib_path("k")
    assert build._lib_path("k") == before  # stable
    (csrc / "hopper.cuh").write_text("#pragma once\n// edited\n")
    assert build._lib_path("k") != before


def test_source_headers_and_flags_each_change_the_library_path(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    paths = {build._lib_path("k")}
    (csrc / "k.cu").write_text('#include "hopper.cuh"\nextern "C" int k() { return 1; }\n')
    paths.add(build._lib_path("k"))
    (csrc / "extra.cuh").write_text("#pragma once\n")  # a new header
    paths.add(build._lib_path("k"))
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-lineinfo"))
    paths.add(build._lib_path("k"))
    assert len(paths) == 4
    assert all(p.parent == tmp_path / "build" and p.name.startswith("k-") and p.suffix == ".so" for p in paths)


def test_defines_build_a_variant_under_its_own_name(tmp_path, monkeypatch):
    """A profile's ``-D`` build (``load(name, defines=...)``) gets its own
    library, never the one the wrappers load."""
    _csrc(tmp_path, monkeypatch)
    plain, stamped = build._lib_path("k"), build._lib_path("k", ("K4_PHASES",))
    assert plain != stamped and stamped == build._lib_path("k", ("K4_PHASES",))
    assert build._flags(("K4_PHASES",)) == (*build.NVCC_FLAGS, "-DK4_PHASES")


def test_ptxas_report_is_read_per_kernel(monkeypatch):
    report = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119k4_flash_fwd_kernelILi128EEEv14CUtensorMap_st' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_119k4_flash_fwd_kernelILi128EEEv14CUtensorMap_st\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 128 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119k4_flash_fwd_kernelILi64ELi4EEEvNS_4ArgsE' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_119k4_flash_fwd_kernelILi64ELi4EEEvNS_4ArgsE\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 120 registers, used 5 barriers, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12dg15k2_dgrad_kernelEPK13__nv_bfloat16' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_12dg15k2_dgrad_kernelEPK13__nv_bfloat16\n"
        "    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 30720 bytes smem, 400 bytes cmem[0]\n"
    )
    monkeypatch.setitem(build._PTXAS, "fake", report)
    assert build.ptxas_kernels("fake") == [
        {"kernel": "k4_flash_fwd_kernel<128>", "stack_frame": 0, "spill_stores": 0, "spill_loads": 0,
         "registers": 168, "static_smem": 0},
        {"kernel": "k4_flash_fwd_kernel<64, 4>", "stack_frame": 0, "spill_stores": 0, "spill_loads": 0,
         "registers": 120, "static_smem": 0},
        {"kernel": "k2_dgrad_kernel", "stack_frame": 16, "spill_stores": 8, "spill_loads": 4, "registers": 96,
         "static_smem": 30720},
    ]
    assert build.ptxas_kernels("not built here") == []
