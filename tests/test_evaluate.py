"""PSNR evaluation utilities."""

import numpy as np

from burn_raymarching.train.evaluate import encode_u8, psnr_u8


def test_psnr_identical_is_inf():
    a = np.random.default_rng(0).integers(0, 255, (64, 3)).astype(np.uint8)
    assert psnr_u8(a, a) == float("inf")


def test_psnr_known_value():
    a = np.zeros((100, 3), np.uint8)
    b = np.full((100, 3), 10, np.uint8)   # MSE = 100
    np.testing.assert_allclose(psnr_u8(a, b),
                               20 * np.log10(255) - 10 * np.log10(100),
                               rtol=1e-9)


def test_encode_matches_save_pipeline():
    x = np.array([[0.0, 0.5, 1.0], [-0.2, 2.0, 0.25]], np.float32)
    got = encode_u8(x)
    want = (np.clip(x, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert got[1, 0] == 0 and got[1, 1] == 255


def test_render_tiled_matches_unchunked_and_culled():
    """render_tiled == direct scene_forward (incl. a padded tail chunk);
    the culled route matches dense when the budget covers every primitive."""
    import jax.numpy as jnp

    from burn_raymarching.data.camera import create_camera_rays
    from burn_raymarching.models.scene import (
        init_scene_params,
        pad_params,
        scene_forward,
    )
    from burn_raymarching.render.preview import CullRender, render_tiled

    params = init_scene_params(7)
    padded, mask = pad_params(params, 8)
    ro, rd = create_camera_rays(24, 24, [0.0, 0.5, -2.5], [0, 0, 0], 50.0)

    want = np.asarray(scene_forward(padded, ro, rd, jnp.float32(32.0),
                                    mask=mask))
    got = render_tiled(padded, ro, rd, smooth_k=32.0, mask=mask, chunk=256)
    assert got.shape == want.shape                 # 576 rays -> padded tail
    # Batch-size-dependent fp reassociation through the 40-step march puts
    # worst-case pixel deltas at ~2e-5; anything beyond would be a bug.
    np.testing.assert_allclose(got, want, atol=1e-4)

    got_culled = render_tiled(padded, ro, rd, smooth_k=32.0, mask=mask,
                              chunk=256,
                              cull=CullRender(tile=16, k_budget=8))
    np.testing.assert_allclose(got_culled, want, atol=2e-4)

    # Morton-tiled culled render: same image, same raster layout (the
    # permutation is inverted on return). order_wh makes cull tiles compact
    # pixel blocks — required for honest culled evals at large M.
    got_morton = render_tiled(padded, ro, rd, smooth_k=32.0, mask=mask,
                              chunk=256, order_wh=(24, 24),
                              cull=CullRender(tile=16, k_budget=8))
    np.testing.assert_allclose(got_morton, want, atol=2e-4)
