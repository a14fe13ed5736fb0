"""The terminal viewer (render/viewer.py) against the JAX package's, and
the CLI's viewer and orbit modes: the ANSI frames byte for byte, the
camera keys, the headless navigation bench, the interactive loop on a
pseudo-terminal, and the orbit's frames."""

import dataclasses
import math
import os
import pty
import sys
import termios
import threading
import time

import numpy as np
import pytest

from gpupathtracer_tpu.config import CameraConfig as JaxCameraConfig
from gpupathtracer_tpu.render import viewer as jax_viewer
from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.render import Renderer, viewer


def _renderer(**kw):
    cfg = RenderConfig(scene_path="proc:cornell", width=16, height=12,
                       max_bounces=2, **kw)
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=16 / 12)
    return Renderer(cfg, "cpu")


@pytest.mark.parametrize("shape", [(6, 5), (7, 3), (1, 4), (33, 17)])
def test_ansi_frame_byte_equal(shape):
    """Seeded images with values outside [0, 1], odd heights (the last
    scanline dropped) and one row (an empty frame)."""
    rng = np.random.RandomState(sum(shape))
    img = rng.uniform(-0.2, 1.2, (*shape, 3)).astype(np.float32)
    got = viewer._ansi_frame(img)
    assert got.encode() == jax_viewer._ansi_frame(img).encode()
    assert got.count("\n") == max(shape[0] // 2 - 1, 0)


def test_apply_keys_match_jax():
    """Seeded key strings (moves, turns, arrows, space, others) from
    seeded cameras: the same camera, moved and reset flags."""
    rng = np.random.RandomState(11)
    alphabet = list("wasdrfhjklqxz ") + ["\x1b[A", "\x1b[B", "\x1b[C",
                                         "\x1b[D"]
    for _ in range(40):
        pos = tuple(float(x) for x in rng.uniform(-5, 5, 3))
        yaw, pitch = (float(x) for x in rng.uniform(-1.4, 1.4, 2))
        keys = "".join(rng.choice(alphabet, rng.randint(0, 12)))
        speed, turn = float(rng.uniform(0.1, 2)), float(rng.uniform(0, 0.3))
        got = viewer._apply_keys(CameraConfig(position=pos, yaw=yaw,
                                              pitch=pitch), keys, speed, turn)
        want = jax_viewer._apply_keys(JaxCameraConfig(
            position=pos, yaw=yaw, pitch=pitch), keys, speed, turn)
        assert got[1:] == want[1:], keys
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0]), keys


def test_bench_viewer_runs_on_cpu():
    r = _renderer()
    fps, enc_ms = viewer.bench_viewer(r, frames=3, warmup=1)
    assert fps > 0 and enc_ms >= 0
    # The scripted path moved the camera: accumulation restarted.
    assert r.cfg.camera.position != (2.75, 2.75, -7.0)
    assert 1 <= r.num_samples <= 5


def test_run_viewer_on_a_pty(tmp_path, monkeypatch):
    """The interactive loop on a pseudo-terminal: w moves the camera, x
    writes one timestamped screenshot into the working folder, q quits;
    the terminal's modes are restored."""
    monkeypatch.chdir(tmp_path)
    master, slave = pty.openpty()
    modes = termios.tcgetattr(slave)
    stdin = open(slave, "r", closefd=False)
    stdout = open(slave, "w", closefd=False)
    out = bytearray()

    def drain():
        while True:
            try:
                chunk = os.read(master, 65536)
            except OSError:
                return
            if not chunk:
                return
            out.extend(chunk)

    def wait_for(text: bytes, start: int, timeout: float = 60.0) -> int:
        end = time.time() + timeout
        while time.time() < end:
            at = out.find(text, start)
            if at >= 0:
                return at + len(text)
            time.sleep(0.02)
        raise AssertionError(f"{text!r} never came: {bytes(out[-400:])!r}")

    threading.Thread(target=drain, daemon=True).start()
    r = _renderer()
    monkeypatch.setattr(sys, "stdin", stdin)
    monkeypatch.setattr(sys, "stdout", stdout)
    loop = threading.Thread(target=viewer.run_viewer, args=(r,),
                            kwargs=dict(move_speed=0.5, max_fps=50.0))
    loop.start()
    try:
        at = wait_for(b"spp] pos=(2.8,2.8,-7.0)", 0)
        os.write(master, b"w")
        at = wait_for(b"spp] pos=(2.8,2.8,-6.5)", at)
        os.write(master, b"x")
        at = wait_for(b" saved viewer-", at)
        os.write(master, b"q")
        loop.join(60)
    finally:
        if loop.is_alive():
            os.write(master, b"q")
            loop.join(60)
    assert not loop.is_alive()
    monkeypatch.undo()
    assert termios.tcgetattr(slave) == modes
    os.close(slave)
    os.close(master)
    shots = [f for f in os.listdir(tmp_path) if f.startswith("viewer-")]
    assert len(shots) == 1 and shots[0].endswith(".png")
    with open(tmp_path / shots[0], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert r.cfg.camera.position[2] == pytest.approx(-6.5)


def test_cli_viewer_bench_and_orbit(tmp_path, capsys):
    """--viewer-bench prints the loop's fps; --orbit 2 writes two frames
    that differ, each the PNG of a Renderer moved there by set_camera."""
    base = ["proc:cornell", "--device", "cpu", "--width", "16", "--height",
            "12", "--max-bounces", "2", "--spp", "1", "--no-cache"]
    assert cli.main(base + ["--viewer-bench", "2"]) == 0
    assert "viewer loop:" in capsys.readouterr().out
    out = str(tmp_path / "o.png")
    assert cli.main(base + ["--orbit", "2", "--out", out]) == 0
    frames = [(tmp_path / f"o-{f:03d}.png").read_bytes() for f in range(2)]
    assert frames[0] != frames[1]
    r = Renderer(cli.build_config(cli.parse_args(base)), "cpu")
    cam = r.cfg.camera
    px, py, pz = cam.position
    for f in range(2):
        ang = math.pi * f
        r.set_camera(dataclasses.replace(
            cam, position=(px * math.cos(ang) - pz * math.sin(ang), py,
                           px * math.sin(ang) + pz * math.cos(ang)),
            yaw=cam.yaw + ang))
        r.render_frame()
        ref = r.save_screenshot(str(tmp_path / f"ref-{f}.png"))
        with open(ref, "rb") as g:
            assert g.read() == frames[f], f
