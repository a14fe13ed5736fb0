"""Frame times and ray-throughput counters (counterpart of FrameStats in
the JAX package's utils/timing.py; role of src/misc/TimeUtil plus
Mrays/s)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class FrameStats:
    """Frame times and rays traced. Ray counts may be device scalars; they
    are read back once, when a statistic is asked for."""

    frame_times: List[float] = field(default_factory=list)
    rays_traced: int = 0
    _pending: List = field(default_factory=list)

    def add_frame(self, dt: float, rays=0) -> None:
        self.frame_times.append(dt)
        if isinstance(rays, int):
            self.rays_traced += rays
        else:
            self._pending.append(rays)

    def finalize(self) -> None:
        if self._pending:
            self.rays_traced += sum(int(r) for r in self._pending)
            self._pending.clear()

    @property
    def avg_fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return len(self.frame_times) / sum(self.frame_times)

    @property
    def mrays_per_sec(self) -> float:
        self.finalize()
        total = sum(self.frame_times)
        if total <= 0.0:
            return 0.0
        return self.rays_traced / total / 1e6

    def report(self) -> str:
        self.finalize()
        return (f"frames={len(self.frame_times)} avg_fps={self.avg_fps:.3f} "
                f"rays={self.rays_traced} mrays/s={self.mrays_per_sec:.2f}")
