"""The sm_90a build check (``tools/aotcheck.py``), the Hopper analog of
the JAX package's AOT compile sweep (``tests/test_aot.py``).

On the CPU the check lists every ``.cu`` of ``csrc/`` and, with no
``nvcc``, raises by name: it never passes without compiling. The
``cuda``-marked case compiles every source for sm_90a on the card's
machine and records each kernel's registers, shared memory and spills.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from bigslice_tpu_torch.tools import aotcheck  # noqa: E402


def test_aotcheck_lists_every_cuda_source():
    names = [p.name for p in aotcheck.sources()]
    assert names == sorted(p.name for p in aotcheck.SRC_DIR.glob("*.cu"))
    assert {"hash_aggregate.cu", "hash_partition.cu", "probe.cu"} <= \
        set(names)
    assert aotcheck.default_out().parent == aotcheck.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in aotcheck.ARCH_FLAGS


def test_aotcheck_raises_by_name_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(aotcheck, "_nvcc", lambda: None)
    out = tmp_path / "aot.json"
    with pytest.raises(aotcheck.NvccNotFound, match="nvcc not found"):
        aotcheck.check(str(out))
    with pytest.raises(aotcheck.NvccNotFound):
        aotcheck.main(["--out", str(out)])
    assert not out.exists()


def test_aotcheck_reads_cuobjdump_and_ptxas_reports():
    usage = aotcheck.parse_resource_usage(
        "Resource usage:\n"
        " Common:\n  GLOBAL:0\n"
        " Function _Z9bs_probe1PKiPii:\n"
        "  REG:8 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:368 TEXTURE:0 "
        "SURFACE:0 SAMPLER:0\n"
        " Function _Z4aggv: REG:64 STACK:16 SHARED:4096 LOCAL:24 "
        "CONSTANT[0]:400\n")
    assert usage["_Z4aggv"] == {"registers": 64, "stack_bytes": 16,
                                "shared_bytes": 4096, "local_bytes": 24}
    # The fields on the line after the function's name.
    assert usage["_Z9bs_probe1PKiPii"] == {"registers": 8, "stack_bytes": 0,
                                           "shared_bytes": 0,
                                           "local_bytes": 0}
    spills = aotcheck.parse_ptxas(
        "ptxas info    : Compiling entry function '_Z4aggv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4aggv\n"
        "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 64 registers\n")
    assert spills == {"_Z4aggv": {"spill_store_bytes": 8,
                                  "spill_load_bytes": 12,
                                  "ptxas_registers": 64}}


@pytest.mark.cuda
def test_aotcheck_builds_every_source_for_sm90a(tmp_path):
    if not torch.cuda.is_available() or aotcheck._nvcc() is None:
        pytest.skip("needs an NVIDIA GPU's machine with nvcc")
    out = tmp_path / "aot.json"
    report = aotcheck.check(str(out))
    assert json.loads(out.read_text()) == report
    assert set(report["sources"]) == {p.name for p in aotcheck.sources()}
    for entry in report["sources"].values():
        assert entry["cubin_bytes"] > 0 and entry["kernels"]
        for k in entry["kernels"].values():
            assert k["registers"] > 0
