"""tools/torch_bench.py, the port's bench, rehearsed on the CPU (--device
cpu: every row on the plain versions at a tiny film, one frame a row):
the line is well formed for every row of the default and the --full
sets and of --quick, and a row that raises ends the bench instead of
being skipped. The rehearsal's times are host times; the test holds only
that they are finite and positive. About 60 s on the CPU, most of it the
--full rehearsal (sponza's three tables take about 11 s to ingest and
run_compact's rehearsal about 14 s)."""

import importlib.util
import json
import math
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _bench():
    spec = importlib.util.spec_from_file_location(
        "torch_bench", os.path.join(REPO, "tools", "torch_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _bench()


@pytest.fixture(scope="module")
def full_line(bench):
    """The --full rehearsal's line, through main() as a user calls it."""
    return bench.main(["--device", "cpu", "--full"])


def _well_formed(bench, line, names):
    json.dumps(line)  # the line is JSON
    rows = line["extra"]["rows"]
    assert list(rows) == names
    entries = set(bench.launches())
    assert {"trace_closest", "trace_anyhit", "trace_cluster_closest",
            "trace_mega", "trace_mega_cluster"} <= entries
    for name, row in rows.items():
        for key in ("s_per_call", "spp_s", "mrays_s"):
            assert math.isfinite(row[key]) and row[key] > 0, (name, key)
        assert row["calls"] >= 1 and row["frame_batch"] >= 1
        # Every entry point's launches over the row's timed frames: none on
        # the CPU, where the wrappers run their plain versions.
        assert set(row["launches"]) == entries
        assert not any(row["launches"].values())
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["unit"] == "Mrays/s"
    assert line["metric"].startswith("cpu_rehearsal_")
    assert line["extra"]["device"].startswith("cpu rehearsal")


def test_full_rehearsal_line_is_well_formed(bench, full_line):
    names = bench.row_names(full=True)
    _well_formed(bench, full_line, names)
    default = bench.row_names()
    assert set(default) < set(names)
    assert [n for n in names if n in default] == default
    assert {"table_pt_megacluster", "sponza_probe_cluster256",
            "bathroom_probe_megacluster256"} <= set(names) - set(default)
    extra = full_line["extra"]
    for key in ("table_direct_fps", "table_direct_batched_spp_s",
                "table_direct_megaregen8_spp_s", "table_pt_fps_wavefront",
                "table_pt_fps_megaregen128", "table_pt_fps",
                "bunny_direct_fps", "realtime_direct_fps",
                "bathroom_256spp_s", "bathroom_1024spp_720p_s"):
        assert math.isfinite(extra[key]) and extra[key] > 0, key
    probes = extra["probes"]
    assert set(probes["sponza"]) == {"default", "fpair", "tsort", "mega",
                                     "cluster", "cluster256"}
    assert probes["sponza_winner"] in probes["sponza"]
    assert probes["bathroom_winner"] in probes["bathroom"]
    assert extra["sponza"]["first_frame_warm_s"] >= 0
    assert extra["sponza"]["median_frame_s"] > 0
    assert extra["rows"]["sponza_probe_tsort"]["bounce_traversal"] == "tsort"
    assert extra["rows"]["table_pt_megaregen128"]["megakernel"]
    # Each table ingested once: MT, tc 128 and tc 256 where a row uses it.
    assert set(extra["scene_ingest_s"]) == {
        "proc:table", "proc:table@tc128", "proc:bunny", "proc:sponza",
        "proc:sponza@tc128", "proc:sponza@tc256", "proc:bathroom",
        "proc:bathroom@tc128", "proc:bathroom@tc256"}
    assert {"node_pop_ray_ps", "leaf_pop_ray_ps",
            "cluster_pop_ray_ps_tc128"} <= set(extra["roofline"])


def test_quick_rehearsal_line_is_well_formed(bench):
    line = bench.run(CPU, quick=True)
    _well_formed(bench, line, bench.row_names(quick=True))
    assert line["extra"]["sponza"]["res"] == "8x8"
    assert "roofline" not in line["extra"]


def test_a_failing_row_ends_the_bench(bench, monkeypatch):
    """A row whose render_frame raises ends the bench with the error: the
    sponza probe's tsort variant fails, and no later row runs."""
    from gpupathtracer_tpu_torch.render import Renderer

    real = Renderer.render_frame
    calls = []

    def render_frame(self, *a, **kw):
        calls.append(self.bounce_traversal)
        if self.bounce_traversal == "tsort":
            raise RuntimeError("tsort frame failed")
        return real(self, *a, **kw)

    monkeypatch.setattr(Renderer, "render_frame", render_frame)
    with pytest.raises(RuntimeError, match="tsort frame failed"):
        bench.run(CPU, quick=True)
    assert calls[-1] == "tsort"
    assert calls.count("tsort") == 1
