"""The port runs where neither JAX nor Pillow nor the JAX package is
installed: a subprocess that refuses jax, PIL and ``gpupathtracer_tpu``
renders proc:cornell on the CPU to a PNG, with the wavefront integrator,
with the megakernel and on cluster leaves, and the PNGs are decoded here
with zlib alone. No module of the port, and not chip_smoke.py, names the
JAX package in an import."""

import ast
import glob
import os
import struct
import subprocess
import sys
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib.abc
import sys


BLOCKED = ("jax", "jaxlib", "PIL", "gpupathtracer_tpu")


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Refuse())
sys.path.insert(0, sys.argv[1])
from gpupathtracer_tpu_torch import cli

rc = cli.main(["proc:cornell", "--device", "cpu", "--spp", "1",
               "--width", "16", "--height", "16", "--out", sys.argv[2]])
rc = rc or cli.main(["proc:cornell", "--device", "cpu", "--spp", "1",
                     "--width", "16", "--height", "16", "--megakernel", "on",
                     "--frame-batch", "4", "--out", sys.argv[3]])
rc = rc or cli.main(["proc:cornell", "--device", "cpu", "--spp", "1",
                     "--width", "16", "--height", "16", "--cluster-tris",
                     "128", "--out", sys.argv[4]])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("LOADED", loaded)
sys.exit(rc)
"""


def _read_png(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()  # filter type "none" on every row
    return raw[:, 1:].reshape(h, w, 3)


def test_port_renders_without_jax_or_pil(tmp_path):
    outs = [str(tmp_path / f"{name}.png")
            for name in ("cornell", "mega", "cluster")]
    proc = subprocess.run([sys.executable, "-c", SCRIPT, REPO, *outs],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout
    for out in outs:
        img = _read_png(out)
        assert img.shape == (16, 16, 3)
        assert img.max() > 0


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_never_import_the_jax_package():
    paths = sorted(glob.glob(os.path.join(REPO, "gpupathtracer_tpu_torch",
                                          "**", "*.py"), recursive=True))
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(paths) > 30
    bad = [(os.path.relpath(p, REPO), m) for p in paths
           for m in _imported_modules(p)
           if m.split(".")[0] in ("gpupathtracer_tpu", "jax", "jaxlib")]
    assert not bad
