"""The kernel build (unet_tpu_torch/_build.py) across processes, on the CPU
with a stand-in for nvcc: ranks that start together and build the same
source compile it once, and every one of them gets the library."""
import os
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

FAKE_NVCC = """#!/bin/sh
# a stand-in for nvcc: logs its call, takes a while, writes the -o file
echo $$ >> "$NVCC_LOG"
sleep 1
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo built > "$out"
"""

BUILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    from unet_tpu_torch import _build
    _build.CSRC, _build.BUILD_DIR = Path(sys.argv[1]), Path(sys.argv[2])
    (lib, log), = _build.build_all(["k"]).values()
    print(lib.name, lib.read_text().strip())
""")


def test_concurrent_builds_compile_once(tmp_path):
    bindir, csrc, out = tmp_path / "bin", tmp_path / "csrc", tmp_path / "kernels"
    bindir.mkdir()
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel source\n")
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}",
               NVCC_LOG=str(tmp_path / "calls.log"),
               PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(csrc), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    results = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in results]
    names = {o.split()[0] for o, _ in results}
    assert len(names) == 1 and all(o.split()[1] == "built" for o, _ in results), results
    assert len((tmp_path / "calls.log").read_text().split()) == 1   # one compile
    assert sorted(p.name for p in out.iterdir()) == ["build.lock", names.pop()]
