"""Compressed .npz writes for session states."""
import zipfile

import numpy as np


def savez_compressed(path, **arrays):
    """np.savez_compressed(path, **arrays) at zlib level 1: the same
    archive members (np.load reads them alike), written several times
    faster from bf16 features cast to fp32, whose zero low halves give
    level 6's match search long chains to walk."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, allowZip64=True,
                         compresslevel=1) as z:
        for name, value in arrays.items():
            with z.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(value), allow_pickle=False)
