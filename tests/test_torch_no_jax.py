"""The port never imports JAX, flax, optax, msgpack or the JAX package.

A fresh interpreter blocks those imports, imports every module of
``pdecontrolgym_tpu_torch`` and checks that none of them got loaded. A second
one blocks gymnasium: the package still imports.
"""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "pdecontrolgym_tpu_torch"

PROBE = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "pdecontrolgym_tpu")

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
# the distribution layer is among them
assert {"pdecontrolgym_tpu_torch.parallel.mesh",
        "pdecontrolgym_tpu_torch.parallel.spatial"} <= set(names)
print(len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 51  # every module was imported


NO_GYM_PROBE = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "gymnasium":
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import pdecontrolgym_tpu_torch as pkg
from pdecontrolgym_tpu_torch.compat import _gym

assert not _gym.HAVE_GYMNASIUM
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
needs_gym = {"pdecontrolgym_tpu_torch.compat.registration"}
for name in names:
    if name in needs_gym:
        try:
            importlib.import_module(name)
        except ImportError:
            continue
        raise AssertionError(f"{name} imported without gymnasium")
    importlib.import_module(name)
assert "gymnasium" not in sys.modules
print(len(names))
"""


def test_port_imports_without_gymnasium():
    """Without gymnasium the package and every module but the registration
    import (the adapters run on the stand-ins of ``compat/_gym.py``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", NO_GYM_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 49


def test_no_source_line_imports_jax():
    offenders = [
        f"{path.relative_to(REPO)}:{i}"
        for path in PKG.rglob("*.py")
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if line.split("#")[0].strip().startswith(
            ("import jax", "from jax", "import flax", "from flax", "import optax",
             "from optax", "import msgpack", "from msgpack",
             "import pdecontrolgym_tpu.", "from pdecontrolgym_tpu.",
             "from pdecontrolgym_tpu import")
        )
    ]
    assert not offenders
