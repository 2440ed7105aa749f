"""Watermark detection CLI: checks image files for the reference's fixed
48-bit invisible watermark (the DWT-DCT scheme of utils/watermark.py) and
prints the reference's confidence buckets.

Counterpart of the repository's scripts/util/detect_watermark.py (the
reference's scripts/demo/detect.py:108-156); numpy only, no device.

    python -m vidseg_diffusion_tpu_torch.scripts.detect_watermark image.png [more.png ...]
"""

import argparse

import numpy as np

from vidseg_diffusion_tpu_torch.utils.watermark import WATERMARK_BITS, classify_match, watermark_match_bits

_CAVEATS = """
    This script tries to detect watermarked images. Please be aware of
    the following:
    - As the watermark is supposed to be invisible, there is the risk that
      watermarked images may not be detected.
    - To maximize the chance of detection make sure that the image has the
      same dimensions as when the watermark was applied.
    - Specific image manipulation may drastically decrease the chance that
      watermarks can be detected.
    - There is also the chance that an image has the characteristics of the
      watermark by chance.
    - The watermark scheme is public; anybody may watermark any images.
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("filename", nargs="+", help="image files to check")
    args = ap.parse_args(argv)
    print(_CAVEATS)

    from PIL import Image

    for fn in args.filename:
        try:
            img = np.asarray(Image.open(fn).convert("RGB"), np.float64)
        except Exception as e:  # an unreadable file is reported and skipped, as the reference does
            print(f"Couldn't read {fn} ({e}). Skipping")
            continue
        try:
            num_bits = int(watermark_match_bits(img))
        except ValueError as e:
            print(f"{fn}: {e}. Skipping")
            continue
        print(f"{fn}: {classify_match(num_bits)}",
              f"Bits that matched the watermark {num_bits} of {len(WATERMARK_BITS)}\n", sep="\n\t")


if __name__ == "__main__":
    main()
