"""Write the progressive and arithmetic-coded JPEG fixtures of the port's
decoder (droid_slam_reserch_tpu_torch/data/jpeg.py):

    python tests/make_torch_jpeg_fixtures.py

from the six ETH3D frames of tests/data/jpeg/ (739x458, quality 80, 4:2:0):

- tests/data/jpeg_progressive/eth3d_00k.jpg: cv2's progressive JPEG
  (IMWRITE_JPEG_PROGRESSIVE, quality 80, 4:2:0) of cv2.imread of frame k;
- tests/data/jpeg_arith/eth3d_00k_seq.jpg and eth3d_00k_prog.jpg: frame k's
  quantised coefficients re-coded with arithmetic coding
  (tests/torch_jpeg_encoder.py) as SOF9, and as SOF10 with libjpeg's
  jpeg_simple_progression script (spectral selection and successive
  approximation);
- tests/data/jpeg_progressive.json and tests/data/jpeg_arith.json: for each
  file, the sha256, shape and dtype of cv2.imread's decode, which
  chip_smoke.py holds the port's decode against on a machine without cv2.
"""
import hashlib
import json
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from droid_slam_reserch_tpu_torch.data import jpeg  # noqa: E402
from torch_jpeg_encoder import encode_arith  # noqa: E402

DATA = os.path.join(HERE, "data")
BASELINE = os.path.join(DATA, "jpeg")
PROGRESSIVE = os.path.join(DATA, "jpeg_progressive")
ARITH = os.path.join(DATA, "jpeg_arith")


def digest(img):
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape), "dtype": str(img.dtype)}


def main():
    os.makedirs(PROGRESSIVE, exist_ok=True)
    os.makedirs(ARITH, exist_ok=True)
    digests = {PROGRESSIVE: {}, ARITH: {}}
    for name in sorted(os.listdir(BASELINE)):
        src = os.path.join(BASELINE, name)
        out = os.path.join(PROGRESSIVE, name)
        cv2.imwrite(out, cv2.imread(src), [cv2.IMWRITE_JPEG_QUALITY, 80,
                                           cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        digests[PROGRESSIVE][name] = digest(cv2.imread(out))
        with open(src, "rb") as f:
            coefs = jpeg.read_coefficients(f.read(), src)
        for tag, progressive in (("seq", False), ("prog", True)):
            arith = name.replace(".jpg", f"_{tag}.jpg")
            with open(os.path.join(ARITH, arith), "wb") as f:
                f.write(encode_arith(coefs, progressive=progressive))
            digests[ARITH][arith] = digest(cv2.imread(os.path.join(ARITH, arith)))
    for folder, table in digests.items():
        with open(folder + ".json", "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main()
