"""Scene and camera JSON interchange — the contracts shared with the
reference's own tooling.

scene.json schema (reference src/bin/train.rs:226-262, read by the
reference's viewer src/bin/viewer.rs:15-23): flat arrays of *evaluated*
(post-activation) physical parameters.

cameras.json schema (reference src/bin/generate.rs:12-18 /
src/bin/train.rs:15-21): [{file, origin[3], target[3], fov}].
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from burn_raymarching.models.scene import SceneParams, activate


def load_cameras(path: str) -> list[dict]:
    """Load a cameras.json, resolving image paths robustly.

    The reference's train binary resolves ``file`` entries against the
    process cwd (train.rs:66-68 reads "data/target_*.png" from the crate
    root). Entries that do not exist from the current directory are
    resolved against the cameras.json location instead: first its parent's
    parent (the crate-root layout, where cameras.json lives in ``data/``
    and entries are ``data/...``-relative), then the json's own directory.
    """
    with open(path) as f:
        cams = json.load(f)
    json_dir = os.path.dirname(os.path.abspath(path))
    root = os.path.dirname(json_dir)
    for c in cams:
        assert {"file", "origin", "target", "fov"} <= set(c), c
        fp = c["file"]
        if os.path.isabs(fp) and not os.path.exists(fp):
            # Absolute-but-missing paths get the same fail-at-load-time
            # treatment as relative ones (ADVICE r3).
            raise FileNotFoundError(f"cameras.json entry {fp!r} not found")
        if not os.path.isabs(fp) and not os.path.exists(fp):
            cands = (os.path.join(json_dir, fp),
                     os.path.join(root, fp),
                     os.path.join(json_dir, os.path.basename(fp)))
            for cand in cands:
                if os.path.exists(cand):
                    c["file"] = cand
                    break
            else:
                # Fail at load time with the full candidate list instead of
                # a cwd-dependent FileNotFoundError later (ADVICE r2).
                raise FileNotFoundError(
                    f"cameras.json entry {fp!r} not found; tried "
                    f"{fp!r} (cwd {os.getcwd()!r}), " +
                    ", ".join(repr(x) for x in cands))
    return cams


def save_cameras(cams: list[dict], path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cams, f, indent=2)


def export_scene_json(
    params: SceneParams,
    path: str,
    mask: Optional[np.ndarray] = None,
) -> dict:
    """Write evaluated physical params in the reference's scene.json schema.

    The reference exports softplus(radius) WITHOUT the +0.01 forward offset
    (train.rs:244) — matched here. Padded slots are dropped.
    """
    centers, colors, radii_fwd, light_dir, ambient = activate(params)
    radii = np.asarray(radii_fwd) - 0.01  # undo forward offset → softplus(raw)
    centers = np.asarray(centers)
    colors = np.asarray(colors)
    if mask is not None:
        valid = np.asarray(mask).astype(bool)
        centers, colors, radii = centers[valid], colors[valid], radii[valid]
    data = {
        "num_spheres": int(centers.shape[0]),
        "centers": centers.reshape(-1).astype(float).tolist(),
        "colors": colors.reshape(-1).astype(float).tolist(),
        "radii": radii.reshape(-1).astype(float).tolist(),
        "light_dir": np.asarray(light_dir).reshape(-1).astype(float).tolist(),
        "ambient_intensity": np.asarray(ambient).reshape(-1).astype(float).tolist(),
    }
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
    return data


def load_scene_json(path: str) -> dict:
    """Load a scene.json (evaluated params) → dict of numpy arrays."""
    with open(path) as f:
        data = json.load(f)
    n = data["num_spheres"]
    return {
        "num_spheres": n,
        "centers": np.asarray(data["centers"], np.float32).reshape(n, 3),
        "colors": np.asarray(data["colors"], np.float32).reshape(n, 3),
        "radii": np.asarray(data["radii"], np.float32).reshape(n, 1),
        "light_dir": np.asarray(data["light_dir"], np.float32),
        "ambient_intensity": np.asarray(data["ambient_intensity"], np.float32),
    }
