"""Write the JPEG fixtures of tests/golden/images/: each JPEG beside PIL's
decode of it (libjpeg-turbo, ``Image.open(path).convert("RGB")``) as an
8-bit RGB PNG, and manifest.json with each file's sha256 and the sha256 of
the decoded pixels.

    python tools/torch_image_fixtures.py [--out tests/golden/images]
    python tools/torch_image_fixtures.py --time   # decode times, port and PIL

Needs Pillow, so it runs where the JAX package's tests run, never on the
card's machine; the port reads the files without it (utils/jpeg.py and
utils/io.py decode_png) and tests/test_torch_images.py and chip_smoke.py
phase 20 hold its decodes to the PNGs. The maps:

- the generated town's four 128x128 maps (scene/samplegen.py), one
  encoding each: checker baseline 4:4:4 at q95, bricks progressive 4:2:0
  at q75, roof 4:2:2 at q50 with restart markers every 5 MCUs, foliage
  with optimized Huffman tables 4:2:0 at q85;
- a grey JPEG (bricks' luma, q90);
- a 1024x1024 4:2:0 map at q75 (a decode at a real texture size);
- a 512x256 equirect sky at q90 (4:2:0).

The PNGs use filters None, Sub and Up only (the port unfilters those
without a per-byte loop), chosen per row by the smallest sum of absolute
bytes, at zlib level 9.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _u8(img: np.ndarray) -> np.ndarray:
    """save_png's float -> uint8 rule."""
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def town_maps() -> dict:
    from gpupathtracer_tpu_torch.scene import samplegen as sg
    return {"checker": _u8(sg._checker()), "bricks": _u8(sg._bricks()),
            "roof": _u8(sg._stripes()), "foliage": _u8(sg._foliage())}


def big_map(n: int = 1024) -> np.ndarray:
    """A 1024x1024 texture: tiles with soft gradients, grout lines and a
    little grain (a stone floor's kind of content)."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    tile = (np.floor(xx * 8) + 3 * np.floor(yy * 8)) % 5
    base = 0.35 + 0.08 * tile[..., None] * np.float32([1.0, 0.9, 0.75])
    shade = 0.85 + 0.15 * np.sin(6.3 * xx + 2.0)[..., None] * np.cos(
        4.1 * yy)[..., None]
    grout = ((np.abs((xx * 8) % 1 - 0.5) > 0.47)
             | (np.abs((yy * 8) % 1 - 0.5) > 0.47))[..., None]
    img = np.where(grout, 0.2, base * shade)
    grain = np.random.RandomState(5).rand(n // 8, n // 8, 1)
    img = img + 0.02 * np.kron(grain, np.ones((8, 8, 1)))
    return _u8(img.astype(np.float32))


def sky(w: int = 512, h: int = 256) -> np.ndarray:
    v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    u = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    img = np.concatenate([0.3 + 0.6 * v + 0 * u, 0.4 + 0.5 * v + 0 * u,
                          0.6 + 0.4 * v + 0.2 * np.sin(8 * np.pi * u) ** 2],
                         axis=-1)
    return _u8(img)


# name -> (pixels, PIL save arguments)
def fixtures() -> dict:
    maps = town_maps()
    grey = (0.299 * maps["bricks"][..., 0] + 0.587 * maps["bricks"][..., 1]
            + 0.114 * maps["bricks"][..., 2] + 0.5).astype(np.uint8)
    return {
        "checker": (maps["checker"], dict(quality=95, subsampling=0)),
        "bricks": (maps["bricks"], dict(quality=75, subsampling=2,
                                        progressive=True)),
        "roof": (maps["roof"], dict(quality=50, subsampling=1,
                                    restart_marker_blocks=5)),
        "foliage": (maps["foliage"], dict(quality=85, subsampling=2,
                                          optimize=True)),
        "grey": (grey, dict(quality=90)),
        "map1024": (big_map(), dict(quality=75, subsampling=2)),
        "sky": (sky(), dict(quality=90, subsampling=2)),
    }


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG, each row filtered None, Sub or Up (the smallest
    sum of absolute signed bytes)."""
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3).astype(np.int16)
    prev = np.zeros(w * 3, np.int16)
    raw = bytearray()
    for row in rows:
        sub = row.copy()
        sub[3:] -= row[:-3]
        cands = [row, sub, row - prev]
        cands = [(c & 0xFF).astype(np.uint8) for c in cands]
        costs = [np.abs(c.view(np.int8).astype(np.int32)).sum()
                 for c in cands]
        k = int(np.argmin(costs))
        raw += bytes([k]) + cands[k].tobytes()
        prev = row
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(bytes(raw), 9))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def time_decodes(folder: str) -> None:
    """Host ms (median of 5 after a warm-up) and MPix/s of each fixture's
    decode: the port's JPEG decoder and PIL's ``convert("RGB")`` on the
    same bytes, and the port's decode of the PNG twin."""
    import statistics
    import subprocess
    import time

    from PIL import Image

    from gpupathtracer_tpu_torch.utils import io as port_io
    from gpupathtracer_tpu_torch.utils.jpeg import decode_jpeg

    cpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    cpu = next((ln.split(":", 1)[1].strip() for ln in cpu.splitlines()
                if ln.startswith("Model name:")), "CPU model not reported")
    with open(os.path.join(folder, "manifest.json")) as f:
        manifest = json.load(f)
    for name, entry in sorted(manifest.items()):
        with open(os.path.join(folder, entry["jpeg"]), "rb") as f:
            jpg = f.read()
        with open(os.path.join(folder, entry["png"]), "rb") as f:
            png = f.read()
        row = []
        for label, fn in (
                ("port", lambda: decode_jpeg(jpg, name)),
                ("PIL", lambda: np.asarray(
                    Image.open(io.BytesIO(jpg)).convert("RGB"))),
                ("port PNG twin", lambda: port_io.decode_png(png, name))):
            fn()
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            ms = statistics.median(ts) * 1e3
            mpix = entry["height"] * entry["width"] / 1e6 / (ms / 1e3)
            row.append(f"{label} {ms:.3f} ms ({mpix:.1f} MPix/s)")
        print(f"{name} {entry['width']}x{entry['height']}: "
              + ", ".join(row) + f"; host {cpu}")


def main(argv=None) -> int:
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "golden",
                                                  "images"))
    ap.add_argument("--time", action="store_true",
                    help="time the decodes of the fixtures in --out "
                         "instead of writing them")
    args = ap.parse_args(argv)
    if args.time:
        time_decodes(args.out)
        return 0
    os.makedirs(args.out, exist_ok=True)
    manifest = {}
    for name, (pixels, kw) in fixtures().items():
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, "JPEG", **kw)
        jpg = buf.getvalue()
        decoded = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"))
        with open(os.path.join(args.out, f"{name}.jpg"), "wb") as f:
            f.write(jpg)
        png_path = os.path.join(args.out, f"{name}.png")
        write_png(png_path, decoded)
        with open(png_path, "rb") as f:
            png = f.read()
        manifest[name] = {
            "jpeg": f"{name}.jpg", "png": f"{name}.png",
            "height": int(decoded.shape[0]), "width": int(decoded.shape[1]),
            "encoding": {k: v for k, v in kw.items()},
            "jpeg_sha256": _sha(jpg), "png_sha256": _sha(png),
            "pixels_sha256": _sha(np.ascontiguousarray(decoded).tobytes())}
        print(f"{name}: {decoded.shape[1]}x{decoded.shape[0]}, JPEG "
              f"{len(jpg)} B, PNG {len(png)} B")
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
