"""tools/torch_kernel_bench.py, the port's kernel A/B harness, rehearsed on
the CPU (where every variant runs its plain version; the times it prints
there are host times and are not checked), and the triangle table it reads
for the dense modes."""

import importlib.util
import os

import numpy as np
import pytest

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.scene import load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_bench",
        os.path.join(REPO, "tools", "torch_kernel_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tri_geom_byte_equal_to_jax():
    cfg = RenderConfig(scene_path="proc:table")
    scene, meta = load_scene(cfg, "cpu")
    jscene, _ = jax_load_scene(JaxRenderConfig.from_json(cfg.to_json()))
    assert scene.tri_geom.shape == (meta.num_triangles, 9)
    assert scene.tri_geom.numpy().tobytes() == \
        np.asarray(jscene.tri_geom).tobytes()


@pytest.mark.parametrize("any_hit", [False, True])
def test_every_mode_traces_the_same_hits(bench, capsys, any_hit):
    """Every tree-walk variant is bitwise equal to the first (the per-ray
    walk) on both ray sets; the dense modes, which round otherwise, agree
    in occlusion."""
    argv = ["--device", "cpu", "--scene", "proc:table", "--n", "512", "--k",
            "128", "--reps", "1", "--interleave", "1,2", "--multi-pop", "2",
            "--check", "128",
            "--mode", "packet,tsort,tsort2,tsort3,subpacket,tsort-sub"
            + (",dense,dense-vpu" if any_hit else "")]
    out = bench.main(argv + (["--any-hit"] if any_hit else []))
    assert "host times" in capsys.readouterr().out
    assert {"packet@128w1:coherent", "packet@128w2:incoherent",
            "packet@q2:coherent", "tsort@128w2:incoherent",
            "subpacket@128w1:coherent",
            "tsort-sub@128w1:incoherent"} <= set(out)
    for key, row in out.items():
        assert row["equal"] == 1.0, key
        # --check: the first 128 lanes against the kernels' plain versions.
        assert row["plain_equal"] == 1.0, key
        assert row["ms"] > 0


def test_dense_modes_and_unported_mode(bench):
    out = bench.main(["--device", "cpu", "--scene", "proc:cornell", "--n",
                      "2048", "--k", "2048", "--reps", "1", "--sets",
                      "coherent", "--check", "256", "--mode",
                      "packet,dense,dense-vpu"])
    # The inverse-matrix test rounds otherwise than Moller-Trumbore: most
    # lanes differ in the last places of t, none by more than that.
    assert set(out) == {"packet@2048w1:coherent", "dense@2048w1:coherent",
                        "dense-vpu@2048w1:coherent"}
    assert all(row["plain_equal"] == 1.0 for row in out.values())
    with pytest.raises(NotImplementedError):
        bench.main(["--device", "cpu", "--scene", "proc:cornell", "--n",
                    "256", "--mode", "treelet"])
    with pytest.raises(ValueError):
        bench.main(["--device", "cpu", "--scene", "proc:cornell", "--n",
                    "256", "--mode", "perray"])
