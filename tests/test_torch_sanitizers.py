"""ASan/UBSan and TSan builds of the port's native library
(``pytextgcn_tpu_torch/build/native_bridge.py::build_sanitized``): its
threaded counting kernel runs the golden and thread-count checks of
``tests/sanitized_worker.py`` under each, in a subprocess with the
sanitizer's runtime preloaded (``tests/torch_sanitized_worker.py``)."""

import os
import subprocess
import sys

import pytest

from pytextgcn_tpu_torch.build.native_bridge import build_sanitized, sanitizer_runtime

MODES = [
    # python itself leaks by sanitizer standards; UB and memory errors in
    # the kernel still abort
    ("asan", {"ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
              "UBSAN_OPTIONS": "halt_on_error=1"}),
    ("tsan", {"TSAN_OPTIONS": "halt_on_error=1", "OPENBLAS_NUM_THREADS": "1"}),
]


@pytest.mark.parametrize("mode,opts", MODES, ids=[m for m, _ in MODES])
def test_port_native_kernel_under_sanitizer(mode, opts):
    so = build_sanitized(mode)
    assert os.path.dirname(so).endswith(os.path.join("pytextgcn_tpu_torch", "_build", "native"))
    rt = sanitizer_runtime(mode)
    assert os.path.exists(rt), rt
    env = dict(os.environ)
    env.update(opts)
    env["LD_PRELOAD"] = rt
    worker = os.path.join(os.path.dirname(__file__), "torch_sanitized_worker.py")
    r = subprocess.run([sys.executable, worker, so], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "SAN_OK" in r.stdout, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"


def test_sanitized_builds_are_separate_libraries():
    paths = {build_sanitized("asan"), build_sanitized("tsan")}
    from pytextgcn_tpu_torch.build.native_bridge import _san_so

    assert len(paths) == 2 and _san_so(None) not in paths
