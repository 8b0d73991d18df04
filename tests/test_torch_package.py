"""The port stands alone: it imports neither JAX nor the reference
package, and its entry points default to the CUDA card."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both packages in one process, as the tests run)
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


def _port_modules():
    return sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        .replace(".__init__", "").rstrip(".")
        for p in PORT.rglob("*.py"))


def test_import_pulls_in_no_jax_and_no_reference():
    mods = ["repro_torch"] + [m for m in _port_modules()
                              if m != "repro_torch."]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'repro' or "
              "m.startswith('repro.')]\n"
              "assert not bad, bad\nprint(len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_sources_import_no_jax_and_no_reference(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def test_open_session_without_device_raises_on_cpu_box():
    """No device= means the card; without one it raises instead of
    carrying on silently on the CPU."""
    from repro_torch.core import Query, open_session
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        open_session(Query.single("red"), 2)
    s = open_session(Query.single("red"), 2, device="cpu")
    assert s.state.device.type == "cpu"


def test_new_service_modules_are_in_the_checks():
    mods = _port_modules()
    for m in ("repro_torch.serve.service", "repro_torch.serve.transport",
              "repro_torch.serve.fault", "repro_torch.serve.simulator",
              "repro_torch.data.pipeline", "repro_torch.launch.serve",
              "repro_torch.kernels.build",
              "repro_torch.kernels.flash_attention.ref",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.configs", "repro_torch.configs.base",
              "repro_torch.configs.gemma3_12b", "repro_torch.sharding.api",
              "repro_torch.models", "repro_torch.models.common",
              "repro_torch.models.attention", "repro_torch.models.blocks",
              "repro_torch.models.lm", "repro_torch.models.moe",
              "repro_torch.models.ssm",
              "repro_torch.convert",
              "repro_torch.cascade", "repro_torch.cascade.scorer",
              "repro_torch.cascade.fit", "repro_torch.train",
              "repro_torch.train.checkpoint", "repro_torch.train.optimizer",
              "repro_torch.train.step"):
        assert m in mods
    from repro_torch import convert
    assert "scorer_params_from_numpy" in convert.__all__
    assert "lm_caches_from_numpy" in convert.__all__
    from repro_torch import models
    from repro_torch.train import step
    assert {"init_caches", "lm_prefill", "lm_decode_step"} <= set(
        models.__all__)
    assert {"make_prefill_step", "make_decode_step"} <= set(step.__all__)


def test_kernel_libraries_are_keyed_on_every_compiled_file(tmp_path):
    """An edited shared header changes both camera libraries' keys, an
    edited source only its own: a stale library is never reused."""
    import shutil
    from repro_torch.kernels import build
    root = tmp_path / "kernels"
    shutil.copytree(build.KERNELS, root,
                    ignore=shutil.ignore_patterns("*.py", "__pycache__"))

    def keys():
        return {n: build.library_path(n, root) for n in build.LIBRARIES}

    before = keys()
    assert len(set(before.values())) == len(build.LIBRARIES)
    hdr = root / "hsv_features" / "csrc" / "hsv_common.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after_header = keys()
    assert all(after_header[n] != before[n] for n in ("ingest", "hist"))
    assert after_header["flash"] == before["flash"]
    hist = root / "hsv_features" / "csrc" / "hist.cu"
    hist.write_text(hist.read_text() + "\n")
    after_hist = keys()
    assert after_hist["hist"] != after_header["hist"]
    assert after_hist["ingest"] == after_header["ingest"]
    flash = root / "flash_attention" / "csrc" / "flash.cu"
    flash.write_text(flash.read_text() + "\n")
    assert keys()["flash"] != after_hist["flash"]


def test_one_build_route_for_every_kernel_library():
    """Every CUDA source of the port is built by ``kernels/build.py``;
    the camera kernels keep their bit-stable flags."""
    from repro_torch.kernels import build
    sources = sorted(str(p.relative_to(build.KERNELS))
                     for p in build.KERNELS.rglob("*.cu"))
    assert sorted(lib.source for lib in build.LIBRARIES.values()) == sources
    for name in ("ingest", "hist"):
        assert "-fmad=false" in build.LIBRARIES[name].flags
    for lib in build.LIBRARIES.values():
        assert "arch=compute_90a,code=sm_90a" in lib.flags


def test_flash_library_is_keyed_on_its_bf16_header(tmp_path):
    """The bf16 kernel lives in ``flash_mma.cuh``: editing it rebuilds the
    flash library and no other."""
    import shutil
    from repro_torch.kernels import build
    root = tmp_path / "kernels"
    shutil.copytree(build.KERNELS, root,
                    ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    before = {n: build.library_path(n, root) for n in build.LIBRARIES}
    hdr = root / "flash_attention" / "csrc" / "flash_mma.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: build.library_path(n, root) for n in build.LIBRARIES}
    assert after["flash"] != before["flash"]
    assert all(after[n] == before[n] for n in ("ingest", "hist"))


PTXAS_LOG = """== flash_attention/csrc/flash.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN9flash_mma14flash_mma_bf16ILi64ELi64EEEv11FlashParamsPK13__nv_bfloat16S4_S4_PS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN9flash_mma14flash_mma_bf16ILi64ELi64EEEv11FlashParamsPK13__nv_bfloat16S4_S4_PS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers, 488 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9flash_mma14flash_mma_bf16ILi256ELi64EEEv11FlashParamsPK13__nv_bfloat16S4_S4_PS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN9flash_mma14flash_mma_bf16ILi256ELi64EEEv11FlashParamsPK13__nv_bfloat16S4_S4_PS2_
    40 bytes stack frame, 44 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 488 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112flash_kernelIfLi64ELi64ELi64EEEv11FlashParamsPKT_S4_S4_PS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112flash_kernelIfLi64ELi64ELi64EEEv11FlashParamsPKT_S4_S4_PS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 488 bytes cmem[0]
"""


def test_ptxas_report_gives_registers_and_spills_per_kernel():
    """The build log's ``-Xptxas -v`` lines, read per kernel; the bf16
    tensor-core kernel's instantiations keyed by head dim."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel
    usage = build.ptxas_usage(PTXAS_LOG)
    assert len(usage) == 3
    fp32 = [u for n, u in usage.items() if "flash_kernelIf" in n]
    assert fp32 == [dict(registers=90, spill_stores=0, spill_loads=0)]
    assert kernel.mma_kernel_usage(PTXAS_LOG) == {
        64: dict(block_k=64, registers=126, spill_stores=0, spill_loads=0),
        256: dict(block_k=64, registers=255, spill_stores=44,
                  spill_loads=48)}
    assert build.ptxas_usage("") == {}
