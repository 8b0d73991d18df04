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
              "repro_torch.data.pipeline", "repro_torch.launch.serve"):
        assert m in mods


def test_kernel_libraries_are_keyed_on_every_compiled_file(tmp_path,
                                                           monkeypatch):
    """An edited shared header changes both libraries' keys, an edited
    source only its own: a stale library is never reused."""
    import shutil
    from repro_torch.kernels.hsv_features import kernel
    csrc = tmp_path / "csrc"
    shutil.copytree(kernel.CSRC, csrc)
    monkeypatch.setattr(kernel, "CSRC", csrc)
    before = {n: kernel.library_path(n) for n in kernel.LIBRARIES}
    assert len(set(before.values())) == len(kernel.LIBRARIES)
    (csrc / "hsv_common.cuh").write_text(
        (csrc / "hsv_common.cuh").read_text() + "\n// edited\n")
    after_header = {n: kernel.library_path(n) for n in kernel.LIBRARIES}
    assert all(after_header[n] != before[n] for n in kernel.LIBRARIES)
    (csrc / "hist.cu").write_text((csrc / "hist.cu").read_text() + "\n")
    after_hist = {n: kernel.library_path(n) for n in kernel.LIBRARIES}
    assert after_hist["hist"] != after_header["hist"]
    assert after_hist["ingest"] == after_header["ingest"]
