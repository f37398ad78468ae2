"""Multisession pipeline stages (mirror of multisession/pipeline.py): the
keyframe image export that ``cli.py euroc --reconstruction_path`` runs.
The alignment, fusion and evaluation stages are not ported yet."""
import glob
import os
import re
import shutil

import numpy as np


def extract_images_by_timestamp(image_dir, tstamps, out_dir, tol=0.5):
    """Export the raw images matching keyframe timestamps — stage 1's
    keyframe image dump (reference loop_detect.py:82-105).

    image_dir: directory of the raw .png frames (EuRoC cam layout);
    tstamps: the video buffer's stored keyframe stamps.  The streams (like
    the reference's, loop_detect.py:79) store ``stride * t`` frame INDICES
    as stamps, and the reference extractor indexes the name-sorted file
    list with them (``sorted_files[idx]``, loop_detect.py:96-105) — so
    integer-valued stamps within range index directly; anything else falls
    back to nearest-timestamp matching within ``tol`` (supports streams
    that carry real ns stamps, e.g. TUM association epochs).
    Returns the copied file list.
    """
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(
        glob.glob(os.path.join(image_dir, "*.png")),
        key=lambda f: int(re.sub(r"\D", "", os.path.basename(f)) or 0),
    )
    stamps = np.array([float(os.path.basename(f)[:-4]) for f in files])
    tstamps = np.asarray(tstamps, np.float64).reshape(-1)
    as_index = np.all(tstamps == np.round(tstamps)) and (
        len(tstamps) == 0 or (tstamps.min() >= 0 and tstamps.max() < len(files))
    )
    copied = []
    for t in tstamps:
        if as_index:
            src = files[int(t)]
        else:
            j = int(np.argmin(np.abs(stamps - t)))
            if abs(stamps[j] - t) > tol * max(1.0, abs(t)):
                continue
            src = files[j]
        dst = os.path.join(out_dir, os.path.basename(src))
        shutil.copy(src, dst)
        copied.append(dst)
    return copied
