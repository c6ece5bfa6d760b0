#!/usr/bin/env python3
"""Free bytes, write rate and SHA-256 rate of the temporary directory, the
three things a checkpoint's save and restore wait on.

    python3 tools/disk_rate.py

Prints the free and total bytes of the temporary directory and of the
current one, then writes one 2.1 GB f32 array with ``np.save`` into a new
temporary directory and hashes the file as ``repro_torch.checkpoint`` does
(one thread), and prints both times; removes what it wrote.
"""
import hashlib
import os
import shutil
import tempfile
import time

import numpy as np


def main():
    for where in (tempfile.gettempdir(), os.getcwd()):
        u = shutil.disk_usage(where)
        print(f"{where}: free {u.free / 1e9:.1f} GB of {u.total / 1e9:.1f} GB")
    d = tempfile.mkdtemp()
    try:
        a = np.ones(2 * 2 ** 30 // 4, dtype=np.float32)
        path = os.path.join(d, "x.npy")
        t0 = time.perf_counter()
        np.save(path, a)
        t1 = time.perf_counter()
        with open(path, "rb") as f:
            hashlib.file_digest(f, "sha256")
        t2 = time.perf_counter()
        print(f"np.save {a.nbytes / 1e9:.1f} GB: {t1 - t0:.2f} s; sha256 of it: {t2 - t1:.2f} s")
    finally:
        shutil.rmtree(d)


if __name__ == "__main__":
    main()
