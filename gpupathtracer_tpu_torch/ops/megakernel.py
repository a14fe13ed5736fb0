"""Megakernel integrator: the whole path per lane in one CUDA kernel
(counterpart of the JAX package's ops/megakernel.py).

Where the wavefront integrator (models/wavefront.py) advances all lanes
bounce by bounce through hundreds of small tensor ops, the megakernel
(csrc/megakernel.cu) runs each lane's whole path in one thread: closest
walk with hit-time capture, emission with the MIS rewrite, NEE with an
any-hit walk, two-lobe BSDF sampling and Russian roulette, with the
counter-based lowbias32 random stream of the JAX kernel. With spp > 1 a
lane whose path ends starts the pixel's next sample in the kernel
(in-kernel regeneration), so one launch renders spp samples.

The estimator, its random stream and its packet layout are the JAX
kernel's (gpupathtracer_tpu/ops/megakernel.py:188 ``_mega_kernel``). The
TPU kernel walks 2048-lane packets with one shared stack; a lane's result
depends only on its own ray, apart from exact ties between hits, so one
thread per lane reproduces it. ``packet_size`` fixes only the lane index
within the packet (``lane32``) and the seed of each packet.

``trace_mega`` launches the kernel for CUDA tensors and runs
``trace_mega_plain`` for CPU tensors. The plain version runs the lanes in
lockstep with the kernel's arithmetic, operation for operation, so on the
card the two agree bit for bit.

On a cluster scene (``scene.cluster_rows``) the walks take the dense
cluster leaf (``trace_mega``'s ``cluster_rows``, the JAX kernel's
``cluster=True``), and shading reads the winner's normal direction and
signed material float from its cluster block.

Scope (``mega_eligible``, the JAX gate unchanged): untextured materials,
a constant-colour sky, no delta materials, no sun, at most 64 materials
and 64 emitters, and tables of at most 100 MB. Every other scene takes the
wavefront integrator.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.math.camera import gen_rays
from gpupathtracer_tpu_torch.math.vecmath import sqrt
from gpupathtracer_tpu_torch.ops import (cuda_build, kernel_cluster,
                                         kernel_traverse)

LANES = 128
PI = math.pi
SQRT_PI = float(np.sqrt(np.float32(PI)))  # jnp.sqrt(PI): a float32 root
INT32_MAX = (1 << 31) - 1
MODELS = ("trowbridge_reitz", "beckmann", "blinn_phong")
# The JAX gate's table limit, VMEM_TABLE_LIMIT of
# gpupathtracer_tpu/ops/pallas_traverse.py:42 (that module imports jax),
# kept so that the same scenes take the same path.
TABLE_LIMIT = 100 * 1024 * 1024
_MASK = 0xFFFFFFFF

# Kernel launches since the last reset, by variant: MT leaves, cluster
# leaves. The wrapper adds one where it launches a kernel and nowhere else.
LAUNCHES = {"trace_mega": 0, "trace_mega_cluster": 0}

_lib: Optional[ctypes.CDLL] = None


def mega_eligible(scene, meta, *, textured: bool, delta: bool, sun: bool,
                  sampler: str = "random") -> bool:
    """Static gate: can this scene and configuration run on the
    megakernel? (The JAX gate, megakernel.py:55-70.)"""
    env = scene.env.image.detach().cpu().numpy()
    const_env = (env.size <= 3 * 64
                 and bool((env == env.reshape(-1, 3)[0]).all()))
    table_bytes = sum(x.numel() * x.element_size()
                      for x in (scene.node_rows, scene.cluster_rows)
                      if x is not None)
    return (not textured and not delta and not sun
            and sampler == "random"
            and const_env
            and meta.num_materials <= 64
            and scene.light_rows.shape[0] <= 64
            and table_bytes <= TABLE_LIMIT)


def pack_mega_tables(scene):
    """(mats [M, 16], lights [L, 16], cdf [L], params [5]) on the scene's
    device: the JAX tables' values without their 128-lane padding. params
    holds (total_area, nee_pdf, env rgb)."""
    total = float(scene.total_light_area)
    env = scene.env.image.detach().cpu().numpy().reshape(-1, 3)[0]
    nee_pdf = 0.5 / total if total > 0 else np.inf
    params = np.asarray([total, nee_pdf, env[0], env[1], env[2]], np.float32)
    return (scene.mat_rows.contiguous(), scene.light_rows.contiguous(),
            scene.light_cdf.contiguous(),
            torch.as_tensor(params, device=scene.node_rows.device))


# --- the random stream -------------------------------------------------------

def uni(seed, sample, bounce, slot: int, lane32):
    """The kernel's uniform in [0, 1) for (packet seed, sample, bounce,
    draw slot, lane32): a lowbias32 hash, its top 24 bits scaled by 2**-24
    (megakernel.py:267-286). Integer arguments are int64 tensors holding
    int32 or uint32 values; the hash runs on uint32 in int64."""
    mul32 = random.mul32
    s = (seed + mul32((bounce + 1) & _MASK, 0x9E3779B9)
         + mul32(sample & _MASK, 0xC2B2AE35)
         + ((slot * 0x85EBCA6B) & _MASK)) & _MASK
    x = lane32 ^ s
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


# --- the plain version ---------------------------------------------------------
#
# Vectors are lists of three [m] tensors, and every expression keeps the
# JAX kernel's order of operations, which csrc/megakernel.cu writes out the
# same way. Divisions go through device tensors (``_Const``): torch on CUDA
# turns a division by a Python number into a multiplication by its
# reciprocal, which rounds differently from the kernel's division.

class _Const:
    def __init__(self, device):
        def c(x):
            return torch.tensor(x, dtype=torch.float32, device=device)
        self.one, self.two, self.three, self.four = c(1.0), c(2.0), c(3.0), \
            c(4.0)
        self.pi, self.two_pi = c(PI), c(2.0 * PI)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _normalize(k, v):
    # JAX: v * rsqrt(max(v.v, 1e-20)). XLA on the CPU computes rsqrt from
    # the x86 rsqrt estimate and two Newton steps, which matches neither
    # 1/sqrt nor the correctly rounded rsqrt; the port takes 1/sqrt here and
    # in the kernel.
    inv = k.one / sqrt(torch.clamp_min(_dot(v, v), 1e-20))
    return [c * inv for c in v]


def _mis(k, top, bottom):
    return k.one / (1.0 + bottom / torch.clamp_min(top, 1e-30))


def _fresnel(f0, cos_theta):
    x = 1.0 - cos_theta
    x5 = x * x
    x5 = x5 * x5 * x
    return [f + (1.0 - f) * x5 for f in f0]


def _distribution(k, model, rough, rough2, ndm, ndm2):
    if model == "trowbridge_reitz":
        divisor = (rough2 - 1.0) * ndm2 + 1.0
        return rough2 / torch.clamp_min(PI * divisor * divisor, 1e-20)
    if model == "beckmann":
        sub = 2.0 * torch.log(SQRT_PI * rough * torch.clamp_min(ndm, 1e-8))
        add = (ndm2 - 1.0) / torch.clamp_min(ndm2 * rough2, 1e-20)
        return torch.exp(add - sub)
    nb = k.two / rough - 2.0
    return ((nb + 1.0) / k.two_pi
            * torch.exp(torch.log(torch.clamp_min(ndm, 1e-20)) * nb))


def _sample_microfacet(k, model, rough, rough2, r0, r1):
    if model == "trowbridge_reitz":
        z2 = torch.clamp_min((1.0 - r0) / (r0 * (rough2 - 1.0) + 1.0), 0.0)
    elif model == "beckmann":
        g = -rough2 * torch.log(torch.clamp_min(1.0 - r0, 1e-20))
        z2 = k.one / (1.0 + g)
    else:
        nb = k.two / rough - 2.0
        z = torch.exp(torch.log(torch.clamp_min(r0, 1e-20)) / (nb + 1.0))
        z2 = z * z
    z = sqrt(z2)
    phi = 2.0 * PI * r1
    radius = sqrt(torch.clamp_min(1.0 - z2, 0.0))
    return [radius * torch.sin(phi), radius * torch.cos(phi), z]


def _vis_ggx(k, rough2, ndx):
    return k.one / torch.clamp_min(
        ndx + sqrt(rough2 * (1.0 - rough2) * ndx * ndx), 1e-5)


def _diffuse_pmf(k, alb, metal, ndo):
    f0 = [0.04 * (1.0 - metal) + a * metal for a in alb]
    fi = _fresnel(f0, 0.5)
    fo = _fresnel(f0, ndo)
    terms = [(1.0 - metal) * (1.0 - x) * (1.0 - y) for x, y in zip(fi, fo)]
    lum = (terms[0] + terms[1] + terms[2]) / k.three
    return torch.clamp(lum, 0.0, 1.0), f0


def _pdf_mf(k, model, rough, rough2, ndm, idm):
    D = _distribution(k, model, rough, rough2, ndm, ndm * ndm)
    return torch.clamp_min(D * ndm / torch.clamp_min(4.0 * idm, 1e-20),
                           1e-10)


def _bsdf_eval(k, model, alb, metal, f0, rough, rough2, n, view, inc, ndo,
               ndi, ndm, idm):
    below = (_dot(n, inc) < 0.0) | (_dot(n, view) < 0.0)
    D = _distribution(k, model, rough, rough2, ndm, ndm * ndm)
    vis = _vis_ggx(k, rough2, ndi) * _vis_ggx(k, rough2, ndo) / k.four
    fm = _fresnel(f0, idm)
    fi = _fresnel(f0, ndi)
    fo = _fresnel(f0, ndo)
    out = []
    for a in range(3):
        spec = fm[a] * D * vis
        diff = alb[a] / k.pi * (1.0 - metal) * (1.0 - fi[a]) * (1.0 - fo[a])
        out.append(torch.where(below, 0.0, spec + diff))
    return out


def _rows_of(table, idx, n_valid: int):
    """table[idx] for 0 <= idx < n_valid, zeros elsewhere (the JAX
    kernel's select loop over the first n_valid rows)."""
    ok = (idx >= 0) & (idx < n_valid)
    row = table[torch.clamp(idx, 0, table.shape[0] - 1)]
    return torch.where(ok[:, None], row, 0.0)


def _closest_capture(g, o, d, t_max, on):
    """The closest walk with hit-time capture (the kernel's
    closest_capture): (t, miss, unnormalized geometric normal [3 x m],
    material id, normal sign)."""
    if g["cl"] is not None:
        # Cluster leaves: the winner's C row (parallel to e1 x e2) and its
        # signed material float (mat_id + 1) * nsign (megakernel.py:1098-1104).
        t, win = kernel_cluster.walk_cluster_plain(
            g["rows"], g["cl"], o, d, t_max, on,
            stack_depth=g["stack_depth"], any_hit=False, pops=g["pops"])
        miss = win < 0
        tc = g["cl"].shape[1] // 3
        c = kernel_cluster.slot_values(g["cl"], win, (0, 1, 2), 2 * tc)
        sm = kernel_cluster.slot_values(g["cl"], win, (7,), 0)[:, 0]
        c = torch.where(miss[:, None], g["miss_slot"][3:6], c)
        sm = torch.where(miss, 0.0, sm)
        nsign = torch.where(sm < 0.0, -1.0, 1.0)
        mid = torch.clamp_min(sm.abs().to(torch.int64) - 1, -1)
        return t, miss, [c[:, a] for a in range(3)], mid, nsign
    t, prim, _, _, at = kernel_traverse._walk_plain(
        g["rows"], o, d, t_max, on, g["stack_depth"], g["leaf_size"],
        any_hit=False, pops=g["pops"])
    miss = prim < 0
    # Hit-time capture: the winning slot's e1, e2, material id, sign.
    slot = g["rows_flat"][at.clamp_min(0)[:, None]
                          + torch.arange(12, device=o.device)]
    slot = torch.where(miss[:, None], g["miss_slot"], slot)
    e1 = [slot[:, 3 + a] for a in range(3)]
    e2 = [slot[:, 6 + a] for a in range(3)]
    mid = slot[:, 10].contiguous().view(torch.int32).long()
    return t, miss, _cross(e1, e2), mid, slot[:, 11]


def _occluded(g, o, d, t_max, on):
    """The any-hit walk (the kernel's occluded): [m] bool."""
    if g["cl"] is not None:
        return kernel_cluster.walk_cluster_plain(
            g["rows"], g["cl"], o, d, t_max, on,
            stack_depth=g["stack_depth"], any_hit=True,
            pops=g["pops"])[1] >= 0
    return kernel_traverse._walk_plain(
        g["rows"], o, d, t_max, on, g["stack_depth"], g["leaf_size"],
        any_hit=True, pops=g["pops"])[1] >= 0


def _bounce(k, g, st, model, nee, max_bounces, n_mats, n_lights):
    """One bounce of the lanes in ``st`` (all alive): megakernel.py
    bounce() after the regeneration, term by term. Updates ``st`` in place
    and returns the number of live shadow rays."""
    o, d, tp, ct = st["o"], st["d"], st["tp"], st["ct"]
    b, smp = st["bounce"], st["sample"]
    m = b.shape[0]
    rnd = lambda slot: uni(st["seed"], smp, b, slot, st["lane32"])

    far = torch.full((m,), 1e20, dtype=torch.float32, device=b.device)
    on = torch.ones(m, dtype=torch.bool, device=b.device)
    t, miss, gn, mid, nsign = _closest_capture(g, torch.stack(o, 1),
                                               torch.stack(d, 1), far, on)
    n = [c * nsign for c in _normalize(k, gn)]
    pos = [o[a] + d[a] * t + 0.003 * n[a] for a in range(3)]
    view = [-c for c in d]
    ndo = torch.clamp_min(_dot(n, view), 0.0)

    mrow = _rows_of(g["mats"], mid, n_mats)
    alb = [mrow[:, a] for a in range(3)]
    emi = [mrow[:, 5 + a] for a in range(3)]
    metal = mrow[:, 4]
    rough = torch.clamp_min(mrow[:, 3] * mrow[:, 3], 1e-4)
    rough2 = rough * rough
    emission = [torch.where(miss, g["env"][a], emi[a]) for a in range(3)]

    # L_e with the MIS rewrite (wavefront.py:299-317).
    dvec = [st["lp"][a] - pos[a] for a in range(3)]
    dist2 = torch.clamp_min(_dot(dvec, dvec), 1e-12)
    pdf0, pdf1 = st["pdf0"], st["pdf1"]
    old_mis = _mis(k, pdf0, pdf1)
    factor = 0.5 * torch.abs(_dot(n, view)) / dist2
    p0n = pdf0 * factor
    p1n = pdf1 * factor
    idt_scale = (p0n / (p0n + p1n + g["nee_pdf"])
                 / torch.clamp_min(old_mis, 1e-30))
    use_rw = (~miss) & (b != 0) & nee
    scale = torch.where(use_rw, idt_scale, 1.0)
    for a in range(3):
        ct[a] = ct[a] + tp[a] * scale * emission[a]
    alive = ~miss

    dpmf, f0 = _diffuse_pmf(k, alb, metal, ndo)
    n_shadow = 0
    if nee:
        u_sel, u_t0, u_t1 = rnd(0), rnd(1), rnd(2)
        selected = u_sel * g["total_area"]
        li = torch.zeros(m, dtype=torch.int64, device=b.device)
        for l in range(n_lights):
            li = li + (g["cdf"][l] <= selected).long()
        li = torch.clamp(li, 0, max(n_lights - 1, 0))
        lrow = _rows_of(g["lights"], li, n_lights)
        lp0, le1, le2, ln, lem = ([lrow[:, j + a] for a in range(3)]
                                  for j in (0, 3, 6, 9, 12))
        sr = sqrt(u_t0)
        bv = u_t1 * sr
        bt = 1.0 - (1.0 - sr) - bv
        lpos = [lp0[a] + le1[a] * bv + le2[a] * bt for a in range(3)]
        delta = [lpos[a] - pos[a] for a in range(3)]
        radius = sqrt(torch.clamp_min(_dot(delta, delta), 1e-20))
        light_pdf = k.one / g["total_area"]
        shadow_tmax = radius - 0.005
        ldir = [c / radius for c in delta]
        m_h = _normalize(k, [view[a] + ldir[a] for a in range(3)])
        ndi_l = torch.clamp_min(_dot(n, ldir), 0.0)
        ndm_l = torch.clamp_min(_dot(n, m_h), 0.0)
        idm_l = torch.clamp_min(_dot(ldir, m_h), 0.0)
        cos_l = torch.abs(-_dot(ln, ldir))
        r2 = radius * radius
        pdf_dir = (dpmf * ndi_l / k.pi
                   + (1.0 - dpmf) * _pdf_mf(k, model, rough, rough2, ndm_l,
                                            idm_l))
        bounce_pdf = pdf_dir * cos_l / r2
        weight = _mis(k, light_pdf, bounce_pdf)
        bsdf_l = _bsdf_eval(k, model, alb, metal, f0, rough, rough2, n, view,
                            ldir, ndo, ndi_l, ndm_l, idm_l)
        lscale = ndi_l * cos_l * weight / (light_pdf * r2)
        lt = [tp[a] * bsdf_l[a] * lscale for a in range(3)]
        light = [lt[a] * lem[a] for a in range(3)]
        shadow_live = alive & ((light[0] != 0.0) | (light[1] != 0.0)
                               | (light[2] != 0.0))
        live = torch.nonzero(shadow_live).squeeze(1)
        n_shadow = live.numel()
        if n_shadow:
            so = torch.stack([pos[a] + 0.001 * n[a] for a in range(3)], 1)
            occ = _occluded(g, so[live], torch.stack(ldir, 1)[live],
                            shadow_tmax[live],
                            torch.ones_like(live, dtype=torch.bool))
            add = torch.zeros_like(shadow_live)
            add[live] = ~occ
            for a in range(3):
                ct[a] = ct[a] + torch.where(add, light[a], 0.0)

    if max_bounces == 0:
        # Pure direct lighting: no continuation (wavefront.py:390-399).
        st["alive"] = torch.zeros_like(alive)
        st["lp"], st["o"] = pos, list(pos)
        return n_shadow

    # BSDF importance sample (Microfacet.glsl:172-193).
    u_c, u_s0, u_s1, u_rr = rnd(3), rnd(4), rnd(5), rnd(6)
    pick_diffuse = u_c < dpmf
    use_x = torch.abs(n[1]) > 0.99
    hx = torch.where(use_x, 1.0, 0.0)
    hy = torch.where(use_x, 0.0, 1.0)
    tgt = _normalize(k, [hy * n[2], -hx * n[2], hx * n[1] - hy * n[0]])
    tgb = _cross(tgt, n)
    radius_d = sqrt(u_s0)
    phi_d = 2.0 * PI * u_s1
    loc_d = [radius_d * torch.sin(phi_d), radius_d * torch.cos(phi_d),
             sqrt(torch.clamp_min(1.0 - u_s0, 0.0))]
    loc_m = _sample_microfacet(k, model, rough, rough2, u_s0, u_s1)

    def to_world(loc):
        return [tgt[a] * loc[0] + tgb[a] * loc[1] + n[a] * loc[2]
                for a in range(3)]

    dir_d = to_world(loc_d)
    m_w = to_world(loc_m)
    odm = _dot(view, m_w)
    dir_s = [2.0 * odm * m_w[a] - view[a] for a in range(3)]
    inc = [torch.where(pick_diffuse, dir_d[a], dir_s[a]) for a in range(3)]
    m_f = _normalize(k, [view[a] + inc[a] for a in range(3)])
    ndi_b = torch.clamp_min(_dot(n, inc), 0.0)
    ndm_b = torch.clamp_min(_dot(n, m_f), 0.0)
    idm_b = torch.clamp_min(_dot(inc, m_f), 0.0)
    pdf_d = dpmf * ndi_b / k.pi
    pdf_s = (1.0 - dpmf) * _pdf_mf(k, model, rough, rough2, ndm_b, idm_b)
    npdf0 = torch.where(pick_diffuse, pdf_d, pdf_s)
    npdf1 = torch.where(pick_diffuse, pdf_s, pdf_d)
    bsdf_b = _bsdf_eval(k, model, alb, metal, f0, rough, rough2, n, view,
                        inc, ndo, ndi_b, ndm_b, idm_b)
    tscale = ndi_b * _mis(k, npdf0, npdf1) / torch.clamp_min(npdf0, 1e-30)
    ntp = [tp[a] * bsdf_b[a] * tscale for a in range(3)]

    # Russian roulette (Iterative.comp:291-300).
    continuation = torch.clamp(
        torch.maximum(ntp[0], torch.maximum(ntp[1], ntp[2])), 0.0, 1.0)
    inv_c = k.one / torch.clamp_min(continuation, 1e-12)
    kill = (u_rr > continuation) | (b > max_bounces)
    st["alive"] = alive & ~kill
    st["tp"] = [c * inv_c for c in ntp]
    st["o"], st["d"], st["lp"] = pos, inc, list(pos)
    st["pdf0"], st["pdf1"] = npdf0, npdf1
    st["bounce"] = b + 1
    return n_shadow


_VEC = ("o", "d", "tp", "ct", "lp")
_SCALAR = ("pdf0", "pdf1", "alive", "bounce", "sample", "seed", "lane32")


def _take(st, idx):
    sub = {f: [c[idx] for c in st[f]] for f in _VEC}
    sub.update({f: st[f][idx] for f in _SCALAR})
    return sub


def _put(st, idx, sub):
    for f in _VEC:
        for c, s in zip(st[f], sub[f]):
            c[idx] = s
    for f in _SCALAR:
        st[f][idx] = sub[f]


def _regenerate(k, st, want, params, pxn, pyn):
    """Lanes ``want`` start their pixel's next sample: the thin-lens raygen
    of megakernel.py:1034-1067 from the camera scalars in params[5:26]."""
    idx = torch.nonzero(want).squeeze(1)
    smp = st["sample"][idx] + 1
    st["sample"][idx] = smp
    zb = torch.zeros_like(smp)
    rnd = lambda slot: uni(st["seed"][idx], smp, zb, slot, st["lane32"][idx])
    u_j0, u_j1, u_l0, u_l1 = rnd(16), rnd(17), rnd(18), rnd(19)
    p = params
    sx = pxn[idx] + u_j0 * p[24]
    sy = pyn[idx] + u_j1 * p[25]
    phi = 2.0 * PI * u_l0
    rd = p[23] * sqrt(u_l1)
    rdx = rd * torch.cos(phi)
    rdy = rd * torch.sin(phi)
    off = [p[17 + a] * rdx + p[20 + a] * rdy for a in range(3)]
    tgt = [p[8 + a] + sx * p[11 + a] + sy * p[14 + a] - off[a]
           for a in range(3)]
    nd = _normalize(k, tgt)
    for a in range(3):
        o_new = p[5 + a] + off[a]
        st["o"][a][idx] = o_new
        st["lp"][a][idx] = o_new
        st["d"][a][idx] = nd[a]
        st["tp"][a][idx] = 1.0
    st["pdf0"][idx] = 1.0
    st["pdf1"][idx] = 1.0
    st["bounce"][idx] = 0
    st["alive"][idx] = True


def trace_mega_plain(rows, mats, lights, cdf, params, o, d, active, seeds, *,
                     stack_depth: int, leaf_size: int, max_bounces: int,
                     nee: bool, model: str, n_mats: int, n_lights: int,
                     packet_size: int, spp: int = 1, pxn=None, pyn=None,
                     cluster_rows=None, fused_nee: bool = False,
                     pops: Optional[dict] = None):
    """Plain torch version of ``trace_mega`` (same arguments and results).

    The lanes run in lockstep: each step regenerates the lanes whose path
    ended (spp > 1), then runs one bounce of every live lane. ``pops``, a
    dict, collects the walks' pop counts (kernel_traverse.count_pops)."""
    n, dev = active.shape[0], active.device
    k = _Const(dev)
    regen = spp > 1
    lane = torch.arange(n, device=dev)

    def vec(x=None):
        if x is None:
            return [torch.zeros(n, dtype=torch.float32, device=dev)
                    for _ in range(3)]
        return [x[:, a].clone() for a in range(3)]

    ones = torch.ones(n, dtype=torch.float32, device=dev)
    st = dict(o=vec(None if regen else o), d=vec(None if regen else d),
              lp=vec(None if regen else o), ct=vec(),
              tp=[ones.clone() for _ in range(3)],
              pdf0=ones.clone(), pdf1=ones.clone(),
              alive=(torch.zeros_like(active) if regen else active.clone()),
              bounce=torch.zeros(n, dtype=torch.int64, device=dev),
              sample=torch.full((n,), -1 if regen else 0, dtype=torch.int64,
                                device=dev),
              seed=seeds.long()[lane // packet_size] & _MASK,
              lane32=lane % packet_size)
    miss_slot = torch.zeros(12, dtype=torch.float32, device=dev)
    miss_slot[3] = miss_slot[7] = miss_slot[11] = 1.0  # e1 = x, e2 = y
    g = dict(rows=rows, rows_flat=rows.reshape(-1), mats=mats,
             lights=lights, cdf=cdf, total_area=params[0],
             nee_pdf=params[1], env=[params[2 + a] for a in range(3)],
             miss_slot=miss_slot, stack_depth=stack_depth,
             leaf_size=leaf_size, cl=cluster_rows, pops=pops)
    rays = 0
    steps = spp * (max_bounces + 2) + 1 if regen else max_bounces + 2
    for _ in range(steps):
        if regen:
            want = ~st["alive"] & (st["sample"] < spp - 1) & active
            if want.any():
                _regenerate(k, st, want, params, pxn, pyn)
        idx = torch.nonzero(st["alive"]).squeeze(1)
        if idx.numel() == 0:
            break
        sub = _take(st, idx)
        rays += idx.numel() + _bounce(k, g, sub, model, nee, max_bounces,
                                      n_mats, n_lights)
        _put(st, idx, sub)
    return (torch.stack(st["ct"], 1),
            torch.tensor(rays, dtype=torch.int64, device=dev))


# --- the kernel --------------------------------------------------------------

def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build("megakernel")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpt_trace_mega.argtypes = [i, i, i, i, p, p, i, p, p, p, p, p,
                                       p, p, p, i, i, i, i, i, i, i, p, p, p]
        lib.gpt_trace_mega.restype = i
        lib.gpt_mega_max_stack.argtypes = []
        lib.gpt_mega_max_stack.restype = i
        if lib.gpt_mega_max_stack() != kernel_traverse.MAX_STACK:
            raise RuntimeError("csrc/bvh_walk.cuh and kernel_traverse.py "
                               "disagree on the stack size")
        _lib = lib
    return _lib


def _check(rows, mats, lights, cdf, params, o, d, active, seeds, *,
           stack_depth, max_bounces, model, n_mats, n_lights, packet_size,
           spp, pxn, pyn, cluster_rows):
    n = active.shape[0]
    dev = active.device
    if packet_size < 1 or n % packet_size:
        raise ValueError(f"N={n} must be a multiple of packet_size="
                         f"{packet_size}")
    if model not in MODELS:
        raise ValueError(f"unknown microfacet model {model!r}")
    if spp < 1 or max_bounces < 0:
        raise ValueError(f"spp={spp}, max_bounces={max_bounces}")
    if not 1 <= stack_depth <= kernel_traverse.MAX_STACK:
        raise ValueError(f"stack_depth {stack_depth} outside 1.."
                         f"{kernel_traverse.MAX_STACK} (the kernel's stack)")
    f32, regen = torch.float32, spp > 1
    want = [("rows", rows, (rows.shape[0], kernel_traverse.ROW_WIDTH), f32),
            ("mats", mats, (max(n_mats, 1), 16), f32),
            ("lights", lights, (max(n_lights, 1), 16), f32),
            ("cdf", cdf, (max(n_lights, 1),), f32),
            ("params", params, (26 if regen else 5,), f32),
            ("active", active, (n,), torch.bool),
            ("seeds", seeds, (n // packet_size,), torch.int32)]
    if cluster_rows is not None:
        kernel_cluster.cluster_width(cluster_rows)
        want.append(("cluster_rows", cluster_rows, tuple(cluster_rows.shape),
                     f32))
    if regen:
        want += [("pxn", pxn, (n,), f32), ("pyn", pyn, (n,), f32)]
    else:
        want += [("o", o, (n, 3), f32), ("d", d, (n, 3), f32)]
    for name, x, shape, dtype in want:
        if x is None or tuple(x.shape) != shape or x.dtype != dtype:
            got = None if x is None else (x.dtype, tuple(x.shape))
            raise ValueError(f"{name} must be {dtype} {shape}, got {got}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, lanes on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def trace_mega(rows, mats, lights, cdf, params, o, d, active, seeds, *,
               stack_depth: int, leaf_size: int, max_bounces: int, nee: bool,
               model: str, n_mats: int, n_lights: int,
               packet_size: int = 2048, spp: int = 1, pxn=None, pyn=None,
               cluster_rows=None, fused_nee: bool = False,
               with_stats: bool = False):
    """Run the megakernel over N lanes (megakernel.py:1308 ``trace_mega``).

    Lane i belongs to packet i // packet_size and draws its random numbers
    with seeds[i // packet_size] and lane32 = i % packet_size; N must be a
    multiple of packet_size. With spp = 1, o and d [N, 3] are the primary
    rays. With spp > 1 (in-kernel regeneration) pxn and pyn [N] are the
    normalized pixel coordinates, params holds the camera scalars in
    [5:26], and the contribution is the sum over spp samples.

    With cluster_rows [Ncl*8, 3*tc], rows is the cluster top tree and the
    walks take the dense cluster leaf. ``fused_nee`` (the TPU kernel's
    deferred-shadow schedule) changes nothing here: the CUDA kernel has one
    schedule; as in the JAX package it does not compose with cluster leaves.

    Returns ([N, 3] contribution, int64 rays) where rays counts the bounce
    rays and the live shadow rays, as the JAX kernel counts them."""
    if cluster_rows is not None and fused_nee:
        raise ValueError("fused_nee does not compose with cluster leaves")
    if with_stats:
        raise NotImplementedError("megakernel pop counters are not ported "
                                  "yet (ROADMAP.md, queue A: port bench)")
    kw = dict(stack_depth=stack_depth, max_bounces=max_bounces, model=model,
              n_mats=n_mats, n_lights=n_lights, packet_size=packet_size,
              spp=spp, pxn=pxn, pyn=pyn, cluster_rows=cluster_rows)
    _check(rows, mats, lights, cdf, params, o, d, active, seeds, **kw)
    if active.device.type == "cpu":
        return trace_mega_plain(rows, mats, lights, cdf, params, o, d, active,
                                seeds, leaf_size=leaf_size, nee=nee, **kw)
    if active.device.type != "cuda":
        raise ValueError(f"the megakernel takes CUDA or CPU tensors, got "
                         f"{active.device}")
    n = active.shape[0]
    regen = spp > 1
    contribution = torch.empty((n, 3), dtype=torch.float32,
                               device=active.device)
    rays = torch.zeros((), dtype=torch.int64, device=active.device)
    if n:
        in0, in1 = (pxn, pyn) if regen else (o, d)
        cluster = cluster_rows is not None
        with torch.cuda.device(active.device):
            err = _library().gpt_trace_mega(
                MODELS.index(model), int(nee), int(regen), int(cluster),
                rows.data_ptr(), cluster_rows.data_ptr() if cluster else None,
                cluster_rows.shape[1] // 3 if cluster else 0,
                mats.data_ptr(), lights.data_ptr(), cdf.data_ptr(),
                params.data_ptr(), in0.data_ptr(), in1.data_ptr(),
                active.data_ptr(), seeds.data_ptr(), n, packet_size,
                stack_depth, max_bounces, n_mats, n_lights, spp,
                contribution.data_ptr(), rays.data_ptr(),
                torch.cuda.current_stream(active.device).cuda_stream)
        if err:
            raise RuntimeError(f"trace_mega launch failed: CUDA error {err}")
        LAUNCHES["trace_mega_cluster" if cluster else "trace_mega"] += 1
    return contribution, rays


# --- raygen and the render entry points ----------------------------------------

def prepare_mega(scene, mega_tables, cam, pixel_x, pixel_y, key, *,
                 width: int, height: int, stack_depth: int, leaf_size: int,
                 max_bounces: int = 64, nee: bool = True,
                 model: str = "trowbridge_reitz", n_mats: int = 1,
                 n_lights: int = 1, packet_size: int = 2048,
                 sample_idx: int = 0, spp: int = 1, fused_nee: bool = False):
    """The raygen of ``render_sample_mega`` (megakernel.py:1454-1500):
    returns (args, kwargs) of its ``trace_mega`` call over the n lanes
    padded to whole packets.

    spp = 1 draws the wavefront's threefry jitter and lens numbers and
    generates the primary rays; spp > 1 passes the normalized pixel
    coordinates and the camera scalars for the kernel's own raygen."""
    n, dev = pixel_x.shape[0], pixel_x.device
    K = min(packet_size, max(n, LANES))
    pad = (-n) % K
    act = torch.arange(n + pad, device=dev) < n
    P = (n + pad) // K
    mats, lights, cdf, params = mega_tables
    kw = dict(stack_depth=stack_depth, leaf_size=leaf_size,
              max_bounces=max_bounces, nee=nee, model=model, n_mats=n_mats,
              n_lights=n_lights, packet_size=K, spp=spp,
              cluster_rows=scene.cluster_rows, fused_nee=fused_nee)
    f32 = dict(dtype=torch.float32, device=dev)
    if spp > 1:
        key = random.fold_in(key, sample_idx)
        seeds = random.randint(key, (P,), 0, INT32_MAX)
        pxn = pixel_x / torch.tensor(width, **f32)
        pyn = pixel_y / torch.tensor(height, **f32)
        if pad:
            pxn = torch.cat([pxn, torch.zeros(pad, **f32)])
            pyn = torch.cat([pyn, torch.zeros(pad, **f32)])
        # params[5:26]: camera scalars and jitter scales for the raygen.
        params_x = torch.cat([
            params, cam.position, cam.lower_left, cam.horizontal,
            cam.vertical, cam.u, cam.v, cam.lens_radius.reshape(1),
            torch.tensor([1.0 / width, 1.0 / height], **f32)])
        return ((scene.node_rows, mats, lights, cdf, params_x, None, None,
                 act, seeds), dict(kw, pxn=pxn, pyn=pyn))
    key, k_jitter, k_lens = random.split(key, 3)
    jitter = random.uniform(k_jitter, (n, 2))
    interp = (torch.stack([pixel_x, pixel_y], dim=-1) + jitter) \
        / torch.tensor([width, height], **f32)
    lens_u = random.uniform(k_lens, (n, 2))
    ray_o, ray_d = gen_rays(cam, interp, lens_u)
    if pad:
        ray_o = torch.cat([ray_o, torch.zeros((pad, 3), **f32)])
        ray_d = torch.cat([ray_d, torch.tensor([[0.0, 0.0, 1.0]], **f32)
                           .expand(pad, 3)])
    seeds = random.randint(random.fold_in(key, sample_idx), (P,), 0,
                           INT32_MAX)
    return ((scene.node_rows, mats, lights, cdf, params, ray_o.contiguous(),
             ray_d.contiguous(), act, seeds), kw)


def render_sample_mega(scene, mega_tables, cam, pixel_x, pixel_y, key, *,
                       with_stats: bool = False, **statics):
    """Raygen and the megakernel for [n] pixel lanes (megakernel.py:1433):
    ([n, 3] contributions, rays). With spp > 1 (a keyword of
    ``prepare_mega``, as are the other statics) the kernel renders spp
    samples in one launch with in-kernel regeneration and the contribution
    is their sum."""
    args, kw = prepare_mega(scene, mega_tables, cam, pixel_x, pixel_y, key,
                            **statics)
    c, rays = trace_mega(*args, with_stats=with_stats, **kw)
    return c[:pixel_x.shape[0]], rays


def render_sample_mega_batch(scene, mega_tables, cam, pixel_x, pixel_y, key,
                             spp: int = 1, sample_idx: int = 0,
                             fori: bool = False, **statics):
    """spp megakernel samples per lane (megakernel.py:1508-1530): one
    launch with in-kernel regeneration, or with ``fori`` one launch per
    sample, sample i drawn with fold_in(key, i)."""
    if not fori:
        return render_sample_mega(scene, mega_tables, cam, pixel_x, pixel_y,
                                  key, sample_idx=sample_idx, spp=spp,
                                  **statics)
    n, dev = pixel_x.shape[0], pixel_x.device
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(spp):
        c, r = render_sample_mega(scene, mega_tables, cam, pixel_x, pixel_y,
                                  random.fold_in(key, i),
                                  sample_idx=sample_idx + i, **statics)
        acc = acc + c
        rays = rays + r
    return acc, rays
