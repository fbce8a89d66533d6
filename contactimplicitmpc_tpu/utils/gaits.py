"""Gait / reference-trajectory assets.

The reference ships pre-computed contact gaits as JLD2 files
(``/root/reference/src/dynamics/*/gaits/*.jld2``) loaded by
``get_trajectory`` (``src/controller/trajectory.jl:143-185``) in three
layouts:

* ``:split_traj``      — keys ``q, u, γ, b, h̄, ū``
* ``:split_traj_alt``  — keys ``qm, um, γm, bm, ψm, ηm, μm, hm``
* ``:joint_traj``      — a serialized ``ContactTraj`` under key ``traj``

JLD2 is HDF5 underneath, so ``h5py`` reads them directly; this module
converts them once (offline) into flat ``.npz`` archives under
``contactimplicitmpc_tpu/assets/gaits`` — this build's equivalent of the
JLD2 artifact store (SURVEY.md §5 checkpoint/resume).

Converted schema (all float64 numpy arrays)::

    q   (H+2, nq)   configurations
    u   (H, nu)     controls
    gamma (H, nc)   impact impulses
    b   (H, nb)     friction impulses
    psi (H, nc)     (zeros when the source lacks them)
    eta (H, nb)
    w   (H, nw)     (zeros when absent)
    mu  ()          friction coefficient
    h   ()          time step
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "assets", "gaits")


def _deref_vecvec(f, ref) -> np.ndarray:
    """Vector{Vector{T}} → (n, m) array."""
    refs = f[ref][()] if not isinstance(ref, np.ndarray) else ref
    return np.stack([np.asarray(f[r][()], np.float64) for r in refs])


def read_jld2_gait(path: str, nu: int = None, nc: int = None,
                   nb: int = None) -> Dict[str, np.ndarray]:
    """Read any of the three reference gait layouts into the flat schema."""
    import h5py

    with h5py.File(path, "r") as f:
        keys = set(f.keys())
        if "traj" in keys:  # :joint_traj — serialized ContactTraj struct
            t = f["traj"][()]
            q = _deref_vecvec(f, f[t["q"]][()])
            u = _deref_vecvec(f, f[t["u"]][()])
            w = _deref_vecvec(f, f[t["w"]][()])
            gam = _deref_vecvec(f, f[t["γ"]][()])
            b = _deref_vecvec(f, f[t["b"]][()])
            z = _deref_vecvec(f, f[t["z"]][()])
            th = _deref_vecvec(f, f[t["θ"]][()])
            h = float(t["h"])
            nq = q.shape[1]
            ncg = gam.shape[1]
            nbg = b.shape[1]
            # unpack ψ, η from stored z (index.jl layout)
            psi = z[:, nq + ncg + nbg: nq + 2 * ncg + nbg]
            eta = z[:, nq + 3 * ncg + nbg: nq + 3 * ncg + 2 * nbg]
            mu = float(th[0, -2])
            return dict(q=q, u=u, w=w, gamma=gam, b=b, psi=psi, eta=eta,
                        mu=np.float64(mu), h=np.float64(h))
        if "qm" in keys:  # :split_traj_alt (trajectory.jl:169-179)
            q = _deref_vecvec(f, f["qm"][()])
            u = _deref_vecvec(f, f["um"][()])
            gam = _deref_vecvec(f, f["γm"][()])
            b = _deref_vecvec(f, f["bm"][()])
            psi = _deref_vecvec(f, f["ψm"][()])
            eta = _deref_vecvec(f, f["ηm"][()])
            mu = float(np.asarray(f["μm"][()]).reshape(-1)[0])
            h = float(np.asarray(f["hm"][()]).reshape(-1)[0])
            horizon = u.shape[0]
            w = np.zeros((horizon, 0))
            return dict(q=q, u=u, w=w, gamma=gam, b=b, psi=psi, eta=eta,
                        mu=np.float64(mu), h=np.float64(h))
        # :split_traj (trajectory.jl:154-168): ū = packed [u; γ; b; ψ; η; ...]
        q = _deref_vecvec(f, f["q"][()])
        u = _deref_vecvec(f, f["u"][()])
        gam = _deref_vecvec(f, f["γ"][()])
        b = _deref_vecvec(f, f["b"][()])
        ubar = _deref_vecvec(f, f["ū"][()])
        h = float(np.mean(np.asarray(f["h̄"][()], np.float64)))
        nuu = u.shape[1]
        ncg = gam.shape[1]
        nbg = b.shape[1]
        psi = ubar[:, nuu + ncg + nbg: nuu + ncg + nbg + ncg]
        eta = ubar[:, nuu + 2 * ncg + nbg: nuu + 2 * ncg + 2 * nbg]
        horizon = u.shape[0]
        return dict(q=q, u=u, w=np.zeros((horizon, 0)), gamma=gam, b=b,
                    psi=psi, eta=eta, mu=np.float64(np.nan),
                    h=np.float64(h))


def convert_gait(src: str, model_name: str, gait_name: str,
                 out_dir: str = ASSET_DIR) -> str:
    data = read_jld2_gait(src)
    dst_dir = os.path.join(out_dir, model_name)
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(dst_dir, gait_name + ".npz")
    np.savez_compressed(dst, **data)
    return dst


def convert_reference_gaits(ref_root: str = "/root/reference",
                            out_dir: str = ASSET_DIR) -> list:
    """Convert every gait JLD2 under the reference tree. Offline utility."""
    import glob

    done, failed = [], []
    for src in sorted(glob.glob(
            os.path.join(ref_root, "src/dynamics/*/gaits/*.jld2"))):
        parts = src.split(os.sep)
        model_name = parts[-3]
        gait_name = os.path.splitext(parts[-1])[0]
        try:
            done.append(convert_gait(src, model_name, gait_name, out_dir))
        except Exception as exc:  # noqa: BLE001 — report and continue
            failed.append((src, repr(exc)))
    return done if not failed else (done, failed)


def load_gait(model_name: str, gait_name: str,
              asset_dir: str = ASSET_DIR) -> Dict[str, np.ndarray]:
    """Load a converted gait by (model, gait) name."""
    path = os.path.join(asset_dir, model_name, gait_name + ".npz")
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


if __name__ == "__main__":  # pragma: no cover
    out = convert_reference_gaits()
    if isinstance(out, tuple):
        done, failed = out
        print(f"converted {len(done)}; FAILED {len(failed)}:")
        for s, e in failed:
            print(" ", s, e)
    else:
        print(f"converted {len(out)} gaits")
