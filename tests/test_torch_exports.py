"""The port's package surface: each subpackage exports every name of its JAX
twin's ``__all__`` that the port has ported (defined in one of the
subpackage's modules), and every public name of ``utils/convert.py``.
"""

import importlib
import pkgutil

import pytest

SUBPACKAGES = ("envs", "ops", "rewards", "agents", "parallel", "utils", "compat")


def _defined_names(package):
    """Names defined at the top level of any module of the port's subpackage."""
    names = set()
    for info in pkgutil.iter_modules(package.__path__):
        module = importlib.import_module(f"{package.__name__}.{info.name}")
        names.update(n for n in vars(module) if not n.startswith("_"))
    return names


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_every_ported_name_of_its_jax_twin(sub):
    twin = importlib.import_module(f"pdecontrolgym_tpu.{sub}")
    port = importlib.import_module(f"pdecontrolgym_tpu_torch.{sub}")
    ported = [n for n in twin.__all__ if n in _defined_names(port)]
    missing = [n for n in ported if n not in port.__all__ or not hasattr(port, n)]
    assert not missing, f"pdecontrolgym_tpu_torch.{sub} does not export {missing}"
    assert all(hasattr(port, n) for n in port.__all__)


def test_utils_exports_every_converter():
    from pdecontrolgym_tpu_torch import utils
    from pdecontrolgym_tpu_torch.utils import convert

    public = [n for n, v in vars(convert).items()
              if not n.startswith("_") and callable(v)
              and getattr(v, "__module__", "") == convert.__name__]
    assert "traffic_state_from_numpy" in public
    assert not [n for n in public if n not in utils.__all__]


def test_parallel_exports_the_twelve_names_of_its_twin():
    """The distribution layer is ported: ``parallel`` exports every name of
    the JAX package's ``parallel.__all__``, ``multihost_env_mesh`` and
    ``put_global`` stay in ``parallel.mesh`` and the ``make_spatial_*``
    references and ``spatial_mesh`` in ``parallel.spatial``, as there."""
    from pdecontrolgym_tpu import parallel as twin
    from pdecontrolgym_tpu.parallel import mesh as twin_mesh
    from pdecontrolgym_tpu.parallel import spatial as twin_spatial
    from pdecontrolgym_tpu_torch import parallel
    from pdecontrolgym_tpu_torch.parallel import mesh, spatial

    assert len(twin.__all__) == 12
    assert sorted(parallel.__all__) == sorted(twin.__all__)
    for module, twin_module, names in (
            (mesh, twin_mesh, ("multihost_env_mesh", "put_global")),
            (spatial, twin_spatial, ("spatial_mesh", "make_spatial_transport_interval",
                                     "make_spatial_transport_episode",
                                     "make_spatial_ns_step"))):
        for name in names:
            assert callable(getattr(twin_module, name)) and callable(getattr(module, name))
    assert parallel.ENV_AXIS == twin.ENV_AXIS and parallel.X_AXIS == twin.X_AXIS
