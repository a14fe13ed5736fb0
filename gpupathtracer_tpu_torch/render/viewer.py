"""Interactive terminal viewer, the live-camera loop (counterpart of the
JAX package's render/viewer.py).

Role of the reference's GLFW window + WASD camera (src/Program.cpp:103-146):
a headless host has no display, so frames are presented as ANSI truecolor
half-blocks in the terminal (two pixels per character cell) and the camera
is driven with WASD/arrow keys read raw from stdin. Camera movement resets
accumulation exactly like Program.cpp:115-120; standing still accumulates
progressively. A frame is rendered on the renderer's device and read back
while the next one is already enqueued (double buffering).

Keys: w/s forward/back, a/d strafe, r/f up/down, arrows (or hjkl) turn,
space reset accumulation, x screenshot (the F2 role, Program.cpp:127-130),
R ground-truth reference render at the current camera (the R key,
Program.cpp:124-126), q quit.
"""

from __future__ import annotations

import dataclasses
import math
import select
import sys
import time


def _read_keys(timeout: float) -> str:
    """Drain pending keypresses (raw mode), waiting up to `timeout`."""
    keys = ""
    end = time.time() + timeout
    while True:
        remain = max(end - time.time(), 0.0)
        ready, _, _ = select.select([sys.stdin], [], [], remain)
        if not ready:
            break
        keys += sys.stdin.read(1)
        end = time.time()  # got one; only drain what's already buffered
    return keys


def _ansi_frame(img) -> str:
    """[H, W, 3] float in [0,1] -> ANSI truecolor half-block string.
    Row 0 is the bottom scanline (GL convention), so draw top-down.

    Fully vectorized: every cell is the FIXED-WIDTH byte template
    ``ESC[38;2;DDD;DDD;DDDm ESC[48;2;DDD;DDD;DDDm ▀`` (zero-padded
    decimals are valid SGR parameters), so the whole frame is one
    preallocated byte array whose digit columns are filled with numpy
    ops (a per-pixel Python loop would make the encode the loop's
    bottleneck)."""
    import numpy as np
    rgb = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)[::-1]
    h = rgb.shape[0] // 2 * 2
    w = rgb.shape[1]
    if h == 0 or w == 0:
        return ""
    top = rgb[0:h:2].reshape(h // 2, w, 3)
    bot = rgb[1:h:2].reshape(h // 2, w, 3)
    vals = np.concatenate([top, bot], axis=2).astype(np.int32)  # [R, W, 6]
    # Cell template: 2 x 19-byte SGR + 3-byte UTF-8 half block = 41 bytes.
    cell = np.frombuffer("\x1b[38;2;000;000;000m"
                         "\x1b[48;2;000;000;000m▀".encode(), np.uint8)
    rows, cols = vals.shape[0], vals.shape[1]
    buf = np.empty((rows, cols, cell.size), np.uint8)
    buf[:] = cell
    # Digit start offsets of the six DDD fields inside the template.
    starts = np.asarray([7, 11, 15, 26, 30, 34])
    d0 = ord("0")
    for f in range(6):
        v = vals[:, :, f]
        s = starts[f]
        buf[:, :, s] = v // 100 + d0
        buf[:, :, s + 1] = (v // 10) % 10 + d0
        buf[:, :, s + 2] = v % 10 + d0
    # Join cells per row, append reset + newline per row.
    tail = np.frombuffer("\x1b[0m\n".encode(), np.uint8)
    flat = np.concatenate(
        [buf.reshape(rows, cols * cell.size),
         np.broadcast_to(tail, (rows, tail.size))], axis=1)
    return flat.tobytes().decode()[:-1]  # drop the trailing newline


def _apply_keys(cam, keys: str, move_speed: float, turn_speed: float):
    """Apply a WASD/arrow key string to a CameraConfig.

    Returns (cam, moved, reset). Rays travel along the pitch/yaw vector
    d = (cos p sin y, sin p, -cos p cos y): generate_image_plane stores
    direction = -d and centers the film target at -direction*focal
    (math/camera.py:40,52, Camera.cpp semantics), so "forward" is +d."""
    fx = math.cos(cam.pitch) * math.sin(cam.yaw)
    fy = math.sin(cam.pitch)
    fz = -math.cos(cam.pitch) * math.cos(cam.yaw)
    rx, rz = -fz, fx  # right = forward x up (y-up)
    px, py, pz = cam.position
    yaw, pitch = cam.yaw, cam.pitch
    moved = reset = False
    for k in keys.replace("\x1b[A", "k").replace("\x1b[B", "j") \
                 .replace("\x1b[C", "l").replace("\x1b[D", "h"):
        m = move_speed
        if k == "w":
            px, py, pz = px + fx * m, py + fy * m, pz + fz * m
        elif k == "s":
            px, py, pz = px - fx * m, py - fy * m, pz - fz * m
        elif k == "a":
            px, pz = px - rx * m, pz - rz * m
        elif k == "d":
            px, pz = px + rx * m, pz + rz * m
        elif k == "r":
            py += m
        elif k == "f":
            py -= m
        elif k == "h":
            yaw -= turn_speed
        elif k == "l":
            yaw += turn_speed
        elif k == "k":
            pitch = min(pitch + turn_speed, 1.5)
        elif k == "j":
            pitch = max(pitch - turn_speed, -1.5)
        elif k == " ":
            reset = True
            continue
        else:
            continue
        moved = True
    if moved:
        cam = dataclasses.replace(cam, position=(px, py, pz),
                                  yaw=yaw, pitch=pitch)
    return cam, moved, reset


def bench_viewer(renderer, frames: int = 60, move_speed: float = 0.25,
                 turn_speed: float = 0.03, warmup: int = 5):
    """Headless navigation-loop benchmark: the exact per-frame work of
    run_viewer (render + present + ANSI encode + camera move + reset)
    driven by a scripted WASD path instead of a tty, so the live-camera
    experience (Program.cpp:103-146's 45-FPS loop) is measurable on the
    card. Returns (fps, encode_ms). The frame string is fully built
    (not written: terminal bandwidth is the user's, not the card's)."""
    import numpy as np
    script = "wwlwwkwwjwwhssdda"  # forward/turn/strafe mix
    cam = renderer.cfg.camera
    enc_s = 0.0
    t0 = time.perf_counter()
    renderer.render_frame()
    pending = renderer.present_device()
    for i in range(warmup + frames):
        if i == warmup:
            t0 = time.perf_counter()
            enc_s = 0.0
        # Double-buffer: enqueue frame i+1's dispatch BEFORE paying frame
        # i's host transfer, so render and readback overlap (the swapchain
        # overlap a windowed renderer gets for free).
        cam, moved, _ = _apply_keys(cam, script[i % len(script)],
                                    move_speed, turn_speed)
        if moved:
            renderer.set_camera(cam)  # resets accumulation, like the loop
        renderer.render_frame()
        nxt = renderer.present_device()
        img = pending.cpu().numpy()  # transfer of frame i
        pending = nxt
        e0 = time.perf_counter()
        s = _ansi_frame(img)
        assert len(s) > 0
        enc_s += time.perf_counter() - e0
    dt = time.perf_counter() - t0
    return frames / dt, enc_s / frames * 1e3


def run_viewer(renderer, move_speed: float = 1.0,
               turn_speed: float = 0.08, max_fps: float = 30.0,
               ref_spp: int = 64) -> None:
    """Progressive interactive loop on an existing Renderer.

    The camera basis matches the reference's yaw/pitch forward vector
    (Camera.cpp; note gen_rays negates the stored direction, so "forward"
    here is -dir)."""
    import termios
    import tty

    cam = renderer.cfg.camera
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    sys.stdout.write("\x1b[2J")  # clear
    try:
        renderer.render_frame()
        pending = renderer.present_device()
        while True:
            # Double-buffered: show the last finished frame while the next
            # one renders (one frame of latency, like any swapchain).
            img = pending.cpu().numpy()
            sys.stdout.write("\x1b[H" + _ansi_frame(img))
            sys.stdout.write(
                f"\x1b[0m\n[{renderer.num_samples:4d} spp] "
                f"pos=({cam.position[0]:.1f},{cam.position[1]:.1f},"
                f"{cam.position[2]:.1f}) yaw={cam.yaw:.2f} "
                f"pitch={cam.pitch:.2f} | wasd/rf move, arrows turn, "
                f"space reset, x shot, R reference, q quit\n")
            sys.stdout.flush()

            keys = _read_keys(1.0 / max_fps)
            if "q" in keys or "\x03" in keys:
                break
            if "x" in keys:  # timestamped screenshot, the F2 role
                from gpupathtracer_tpu_torch.utils.io import timestamped_name
                path = renderer.save_screenshot(timestamped_name("viewer"))
                sys.stdout.write(f"\x1b[0m saved {path}\n")
                keys = keys.replace("x", "")
            if "R" in keys:
                # Ground-truth render at the current camera (the R key,
                # Program.cpp:124-126 / RenderReference): accumulate
                # `ref_spp` uniform-hemisphere reference samples, save
                # with the elapsed seconds in the name, resume navigation.
                from gpupathtracer_tpu_torch.utils.io import timestamped_name
                sys.stdout.write(f"\x1b[0m reference render "
                                 f"({ref_spp} spp)...\n")
                sys.stdout.flush()
                renderer.reset_samples()
                rt0 = time.time()
                for s in range(ref_spp):
                    renderer.render_frame("reference")
                    if (s + 1) % 16 == 0:
                        sys.stdout.write(f"  {s + 1}/{ref_spp} spp\n")
                        sys.stdout.flush()
                path = renderer.save_screenshot(timestamped_name(
                    f"reference-{time.time() - rt0:.0f}s"))
                sys.stdout.write(f" saved {path}\n")
                renderer.reset_samples()
                keys = keys.replace("R", "")
            if keys:
                cam, moved, reset = _apply_keys(cam, keys, move_speed,
                                                turn_speed)
                if reset:
                    renderer.reset_samples()
                if moved:
                    renderer.set_camera(cam)  # resets accumulation
            renderer.render_frame()   # next sample (or first at new camera)
            pending = renderer.present_device()
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")
