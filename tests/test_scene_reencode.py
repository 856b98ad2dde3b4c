"""raw_from_physical (physical → raw re-encode) round-trip tests.

The helper inverts activate() (models/scene.py) the same way the reference
re-encodes child radii at split time via softplus⁻¹ = ln(eˣ−1)
(src/training.rs:203-204). Used by the ceiling/control evaluations
(docs/PARITY.md, scripts/run_c5.py).
"""

import jax.numpy as jnp
import numpy as np

from burn_raymarching.models.scene import activate, raw_from_physical


def test_round_trip_recovers_physical():
    rng = np.random.default_rng(0)
    m = 17
    centers = rng.normal(0.0, 0.5, (m, 3)).astype(np.float32)
    colors = rng.uniform(0.05, 0.95, (m, 3)).astype(np.float32)
    radii = rng.uniform(0.02, 0.8, (m, 1)).astype(np.float32)

    raw = raw_from_physical(centers, colors, radii,
                            light_dir=(-0.5, 0.5, -1.0), ambient=0.1)
    c, col, r, ld, amb = activate(raw)

    np.testing.assert_allclose(np.asarray(c), centers, rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(col), colors, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r), radii, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ld), [-0.5, 0.5, -1.0])
    np.testing.assert_allclose(np.asarray(amb), [0.1], rtol=1e-5)


def test_extreme_colors_stay_finite():
    raw = raw_from_physical(
        np.zeros((2, 3), np.float32),
        np.asarray([[0.0, 1.0, 0.5], [1.0, 0.0, 0.5]], np.float32),
        np.full((2, 1), 0.2, np.float32),
    )
    assert np.isfinite(np.asarray(raw.colors)).all()
    _, col, *_ = activate(raw)
    # Saturated channels land within clip distance of their target.
    np.testing.assert_allclose(
        np.asarray(col), [[0.0, 1.0, 0.5], [1.0, 0.0, 0.5]], atol=1e-5)


def test_tiny_radius_clamped_to_representable():
    # radius < the 0.01 softplus floor cannot be represented exactly; the
    # re-encode clamps to the 1e-4-above-floor minimum instead of -inf/NaN.
    raw = raw_from_physical(np.zeros((1, 3), np.float32),
                            np.full((1, 3), 0.5, np.float32),
                            np.asarray([[0.005]], np.float32))
    assert np.isfinite(np.asarray(raw.radii)).all()
    _, _, r, _, _ = activate(raw)
    assert float(jnp.squeeze(r)) >= 0.01
