"""Build the ``celeba_{size}.npz`` cache of the port from CelebA's JPEGs.

    python -m diffusion_model_universal_torch.scripts.build_celeba_cache \
        <data_dir> [--size 64] [--crop 178] [--threads N]

Expects ``<data_dir>/img_align_celeba/*.jpg`` and
``list_eval_partition.txt`` (the official layout; nothing is downloaded)
and writes ``<data_dir>/celeba_{size}.npz`` with ``images`` (uint8 NHWC)
and ``splits`` (0/1/2 from the partition file), which
``datasets/sources.py::load_celeba`` takes before the JPEGs. Decoding
needs PIL; the cache does not, so a machine without PIL trains from it.
The JPEGs are cropped and resized as the reference's default path does
(its C++ loader's bilinear: ``datasets/sources.py::
decode_jpegs_crop_resize``), so the cache holds the reference's bytes.
A larger cache already there is shrunk instead of decoding again.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_dir")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--crop", type=int, default=178)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 8)
    args = ap.parse_args(argv)

    import numpy as np

    from ..datasets import sources
    from ..datasets.pipeline import host_resize

    out = os.path.join(args.data_dir, f"celeba_{args.size}.npz")
    data, split_ids = sources.load_celeba(args.data_dir,
                                          image_size=args.size)
    t0 = time.perf_counter()
    if isinstance(data, np.ndarray):
        if data.shape[1] == args.size:
            print(f"celeba_{args.size} cache already present; nothing to do")
            return out
        images = host_resize(data, args.size)
        what = f"shrank the {data.shape[1]}² cache"
    else:
        images = sources.decode_jpegs_crop_resize(
            data, args.crop, args.size, num_threads=args.threads)
        what = f"decoded {len(data)} JPEGs"
    secs = time.perf_counter() - t0
    extra = {} if split_ids is None else {"splits": split_ids}
    np.savez(out, images=images, **extra)
    print(f"{what} in {secs:.1f} s ({len(images) / max(secs, 1e-9):.0f} "
          f"images/s) -> {out} ({os.path.getsize(out) / 1e9:.2f} GB)")
    return out


if __name__ == "__main__":
    main()
