"""Background removal for real-photo captures.

Equivalent of src/bin/chromakey.rs: resize to 256x256 (Lanczos), keep bright
reddish pixels inside the center crop (brightness^2 > 150^2, r > b + 20,
50 < x,y < 206), black out everything else. Vectorized NumPy instead of the
reference's per-pixel loop. Camera frames are JPEGs, so this capture tool
(alone in the package) needs Pillow: ``pip install .[capture]``.

Usage: python -m burn_raymarching.tools.chromakey
           [--in data/tomato/images] [--out data/tomato/images_nobg]
           [--ext jpg] [--min-brightness 150] [--red-margin 20]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def chromakey_image(
    img: "PIL.Image.Image",
    size: int = 256,
    min_brightness: float = 150.0,
    red_margin: float = 20.0,
    border: int = 50,
) -> np.ndarray:
    """Returns a [size, size, 3] uint8 array with background blacked out."""
    from PIL import Image

    resized = img.convert("RGB").resize((size, size), Image.LANCZOS)
    a = np.asarray(resized).astype(np.float32)
    brightness = (a * a).sum(axis=2)
    keep = (
        (brightness > min_brightness * min_brightness)
        & (a[:, :, 0] > a[:, :, 2] + red_margin)
    )
    # Center crop (chromakey.rs:41-45): x and y strictly inside the border.
    yy, xx = np.mgrid[0:size, 0:size]
    inside = (xx > border) & (xx < size - border) & (yy > border) & (yy < size - border)
    mask = keep & inside
    out = np.where(mask[:, :, None], a, 0.0)
    return out.astype(np.uint8)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--in", dest="input_dir", default="data/tomato/images")
    parser.add_argument("--out", dest="output_dir",
                        default="data/tomato/images_nobg")
    parser.add_argument("--ext", default="jpg")
    parser.add_argument("--min-brightness", type=float, default=150.0)
    parser.add_argument("--red-margin", type=float, default=20.0)
    args = parser.parse_args(argv)
    from PIL import Image

    os.makedirs(args.output_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(args.input_dir)):
        if not name.endswith("." + args.ext):
            continue
        img = Image.open(os.path.join(args.input_dir, name))
        out = chromakey_image(img, min_brightness=args.min_brightness,
                              red_margin=args.red_margin)
        Image.fromarray(out).save(os.path.join(args.output_dir, name))
        n += 1
    print(f"✅ Removed backgrounds on {n} images → {args.output_dir}")


if __name__ == "__main__":
    main()
