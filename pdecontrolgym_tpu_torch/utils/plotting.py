"""Figure utilities for the PDE families.

Counterpart of ``pdecontrolgym_tpu/utils/plotting.py``. The reference does
this plotting inline in every example script and notebook (e.g. the styled 3D
space-time surface at ``examples/transportPDE/transport1Dbackstepping.py:
100-131``); here it is one importable function.

All functions take NumPy arrays or tensors (on any device: they are copied to
the host on entry), import matplotlib lazily, and return the created ``Axes``
so callers can restyle. Nothing here runs on the card's hot path.
"""

from __future__ import annotations

import numpy as np

__all__ = ["surface_1d", "spacetime_1d", "ns_fields",
           "load_csv", "load_csv_all", "load_jsonl", "reward_curves",
           "linestyle_tuple"]

# the reference's linestyle table for multi-curve figures
# (examples/transportPDE/utils.py:90-106, duplicated x3 there)
def _host(a):
    """A tensor (on any device) or array-like as a NumPy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


linestyle_tuple = [
    ("solid", "solid"),
    ("dotted", (0, (1, 1))),
    ("dashed", (0, (5, 5))),
    ("dashdotted", (0, (3, 5, 1, 5))),
    ("densely dashed", (0, (5, 1))),
    ("densely dashdotted", (0, (3, 1, 1, 1))),
    ("dashdotdotted", (0, (3, 5, 1, 5, 1, 5))),
    ("loosely dashed", (0, (5, 10))),
]


def load_csv(filename):
    """TensorBoard-exported scalar CSV → ``(timesteps, rewards)``.

    Same contract as the reference's figure pipeline
    (``examples/transportPDE/utils.py:58-70``): rows are
    ``walltime,step,value`` with one header line.
    """
    data = np.genfromtxt(filename, delimiter=",", skip_header=1)
    data = np.atleast_2d(data)
    return data[:, 1].astype(int).tolist(), data[:, 2].astype(float).tolist()


def load_csv_all(filename):
    """Like :func:`load_csv` but also returns wall time
    (``examples/transportPDE/utils.py:72-88``):
    ``(walltime, timesteps, rewards)``."""
    data = np.genfromtxt(filename, delimiter=",", skip_header=1)
    data = np.atleast_2d(data)
    return (data[:, 0].astype(float).tolist(),
            data[:, 1].astype(int).tolist(),
            data[:, 2].astype(float).tolist())


def load_jsonl(filename, key="mean_reward"):
    """``utils.metrics.MetricsLogger`` JSONL → ``(steps, values)`` for the
    given metric key (rows missing the key are skipped)."""
    import json

    steps, values = [], []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if key in row:
                steps.append(int(row["step"]))
                values.append(float(row[key]))
    return steps, values


def reward_curves(curves, labels=None, ax=None, smooth=1, xlabel="iteration",
                  ylabel="mean episode reward"):
    """Reward-vs-steps training-curve figure (the reference builds these from
    TB CSV exports in its docs; ``examples/transportPDE/utils.py:58-106``).

    ``curves``: list of ``(steps, values)`` pairs — from :func:`load_csv` or
    :func:`load_jsonl`. ``smooth``: trailing moving-average window (each
    plotted point averages the window ENDING at its step). Returns the
    ``Axes``.
    """
    plt = _require_pyplot()
    if ax is None:
        _, ax = plt.subplots(figsize=(5.5, 3.4))
    labels = labels or [f"run {i}" for i in range(len(curves))]
    for i, ((steps, values), label) in enumerate(zip(curves, labels)):
        v = np.asarray(values, float)
        if smooth > 1 and v.size >= smooth:
            kern = np.ones(smooth) / smooth
            v = np.convolve(v, kern, mode="valid")
            steps = np.asarray(steps)[smooth - 1:]
        ax.plot(steps, v, label=label,
                linestyle=linestyle_tuple[i % len(linestyle_tuple)][1])
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend()
    ax.figure.tight_layout()
    return ax


def _require_pyplot():
    import matplotlib

    if matplotlib.get_backend().lower() not in ("agg", "module://matplotlib_inline.backend_inline"):
        try:  # headless images: fall back silently
            import matplotlib.pyplot  # noqa: F401
        except Exception:  # pragma: no cover
            matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def surface_1d(history, T, X, ax=None, stride_t=None, x0=0.0, **surface_kw):
    """The reference's signature space-time surface plot of ``u(x, t)``.

    ``history``: array ``(nt, nx)`` of state rows over an episode (e.g. the
    stacked ``obs`` of a ``parallel.rollout.rollout``). ``stride_t`` subsamples the
    time axis (the reference uses ``rstride`` for the same purpose); default
    keeps ≤200 time rows. Returns the 3D ``Axes``.
    """
    u = _host(history)
    if stride_t is None:
        stride_t = max(1, u.shape[0] // 200)
    u = u[::stride_t]
    plt = _require_pyplot()
    if ax is None:
        fig = plt.figure(figsize=(7, 4))
        ax = fig.add_subplot(projection="3d")
    spatial = np.linspace(x0, X, u.shape[1])
    temporal = np.linspace(0, T, u.shape[0])
    xx, tt = np.meshgrid(spatial, temporal)
    kw = dict(edgecolor="black", lw=0.2, alpha=1, color="white", shade=False,
              rasterized=True, antialiased=True)
    kw.update(surface_kw)
    ax.plot_surface(xx, tt, u, **kw)
    ax.view_init(10, 15)
    ax.set_xlabel("x")
    ax.set_ylabel("Time")
    ax.set_zlabel(r"$u(x, t)$", rotation=90)
    ax.zaxis.set_rotate_label(False)
    return ax


def spacetime_1d(history, T, X, ax=None, cmap="RdYlGn_r", label=None):
    """2D space-time heatmap of a 1D field (the traffic notebooks' view).

    ``history``: ``(nt, nx)``. Returns the ``Axes`` (colorbar attached when a
    new figure is created).
    """
    h = _host(history)
    plt = _require_pyplot()
    new_fig = ax is None
    if new_fig:
        _, ax = plt.subplots(figsize=(6, 3.2))
    im = ax.imshow(h.T, aspect="auto", origin="lower", extent=[0, T, 0, X],
                   cmap=cmap)
    ax.set_xlabel("t")
    ax.set_ylabel("x")
    if label:
        ax.set_title(label)
    if new_fig:
        ax.figure.colorbar(im, ax=ax)
    return ax


def ns_fields(U, X, Y, ax=None, density=1, cmap="viridis"):
    """Speed contour + velocity quiver of a 2D NS field.

    ``U``: ``(ny, nx, 2)`` or a tuple ``(u, v)`` of ``(ny, nx)`` arrays (the
    env state layout, envs/navier_stokes.py). ``density`` subsamples the
    quiver arrows. Returns the ``Axes``.
    """
    if isinstance(U, (tuple, list)):
        u, v = (_host(c) for c in U)
    else:
        U = _host(U)
        u, v = U[..., 0], U[..., 1]
    plt = _require_pyplot()
    new_fig = ax is None
    if new_fig:
        _, ax = plt.subplots(figsize=(5, 4.2))
    ny, nx = u.shape
    xs = np.linspace(0, X, nx)
    ys = np.linspace(0, Y, ny)
    speed = np.hypot(u, v)
    cf = ax.contourf(xs, ys, speed, levels=24, cmap=cmap)
    s = max(1, int(density))
    step = max(1, nx // (16 * s))
    ax.quiver(xs[::step], ys[::step], u[::step, ::step], v[::step, ::step],
              color="white", scale_units="xy")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    if new_fig:
        ax.figure.colorbar(cf, ax=ax, label="|u|")
    return ax
