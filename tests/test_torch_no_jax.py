"""The port never imports JAX, flax, optax or the JAX package.

A fresh interpreter blocks those imports, imports every module of
``pdecontrolgym_tpu_torch`` and checks that none of them got loaded.
"""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "pdecontrolgym_tpu_torch"

PROBE = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "pdecontrolgym_tpu")

def blocked(name):
    return name.split(".")[0] in BLOCKED

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]  # loaded before us (e.g. by a site hook): start clean

class Block:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import pdecontrolgym_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if blocked(m)]
print(len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 26  # every module was imported


def test_no_source_line_imports_jax():
    offenders = [
        f"{path.relative_to(REPO)}:{i}"
        for path in PKG.rglob("*.py")
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if line.split("#")[0].strip().startswith(
            ("import jax", "from jax", "import flax", "from flax", "import optax",
             "from optax", "import pdecontrolgym_tpu.", "from pdecontrolgym_tpu.",
             "from pdecontrolgym_tpu import")
        )
    ]
    assert not offenders
