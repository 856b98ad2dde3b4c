"""Camera ray generation vs a direct scalar-loop oracle (reference
src/camera.rs semantics)."""

import numpy as np

from burn_raymarching.data.camera import create_camera_rays


def _oracle_rays(width, height, eye, target, fov_deg):
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)

    def normalize(v):
        n = np.sqrt((v * v).sum())
        return v / n if n > 0 else v * 0

    forward = normalize(target - eye)
    right = normalize(np.cross(forward, np.array([0.0, 1.0, 0.0], np.float32)))
    up = np.cross(right, forward)
    aspect = width / height
    half_h = np.tan(np.radians(fov_deg) / 2)
    half_w = aspect * half_h
    dirs = np.zeros((height * width, 3), np.float32)
    i = 0
    for y in range(height):
        for x in range(width):
            u = (x / width) * 2 - 1
            v = -((y / height) * 2 - 1)
            d = right * (u * half_w) + up * (v * half_h) + forward
            dirs[i] = d / np.sqrt((d * d).sum())
            i += 1
    org = np.tile(eye[None], (height * width, 1))
    return org, dirs


def test_rays_match_scalar_oracle():
    ro, rd = create_camera_rays(8, 6, [0.0, 0.5, -2.5], [0.0, 0.0, 0.0], 50.0)
    oro, ord_ = _oracle_rays(8, 6, [0.0, 0.5, -2.5], [0.0, 0.0, 0.0], 50.0)
    np.testing.assert_allclose(np.asarray(ro), oro, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rd), ord_, atol=1e-6)


def test_rays_match_oracle_offaxis():
    ro, rd = create_camera_rays(5, 7, [2.5, 0.5, 1.0], [0.1, -0.2, 0.0], 60.0)
    oro, ord_ = _oracle_rays(5, 7, [2.5, 0.5, 1.0], [0.1, -0.2, 0.0], 60.0)
    np.testing.assert_allclose(np.asarray(ro), oro, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rd), ord_, atol=1e-5)


def test_near_vertical_camera():
    # The reference's top camera nudges z by -0.001 to avoid a degenerate
    # cross product (generate.rs:66-70); the same pose must work here.
    ro, rd = create_camera_rays(4, 4, [0.0, 2.5, -0.001], [0.0, 0.0, 0.0], 50.0)
    assert np.isfinite(np.asarray(rd)).all()
    # Central direction points roughly straight down.
    center = np.asarray(rd).reshape(4, 4, 3)[2, 2]
    assert center[1] < -0.9


def test_ray_dirs_unit_norm():
    _, rd = create_camera_rays(16, 16, [0, 0, -2.5], [0, 0, 0], 50.0)
    lens = np.linalg.norm(np.asarray(rd), axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-6)
