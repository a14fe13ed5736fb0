"""Surface interactions: the dot products every BSDF term needs
(counterpart of the JAX package's models/interaction.py; reference:
src/shaders/common/Material.glsl:57-130). All fields are [N]-shaped; the
tangent frame matches ConstructTBN (helper axis +X when |n.y| > 0.99).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpupathtracer_tpu_torch.math.vecmath import construct_tbn, nndot, normalize


class SurfaceInteraction(NamedTuple):
    normal: torch.Tensor      # [N,3] geometric normal (MUST equal face normal)
    outgoing: torch.Tensor    # [N,3] view vector
    incoming: torch.Tensor    # [N,3] light vector
    microfacet: torch.Tensor  # [N,3] half vector
    ndo: torch.Tensor         # [N]
    ndi: torch.Tensor
    ndm: torch.Tensor
    ndm2: torch.Tensor
    idm: torch.Tensor
    tangent: torch.Tensor     # [N,3] TBN columns
    bitangent: torch.Tensor


def make_interaction(n, outgoing) -> SurfaceInteraction:
    """Partial constructor (Material.glsl:99-109): incoming not yet known."""
    t, b, _ = construct_tbn(n)
    z = torch.zeros(n.shape[:-1], dtype=n.dtype, device=n.device)
    z3 = torch.zeros_like(n)
    return SurfaceInteraction(
        normal=n, outgoing=outgoing, incoming=z3, microfacet=z3,
        ndo=nndot(n, outgoing), ndi=z, ndm=z, ndm2=z, idm=z,
        tangent=t, bitangent=b)


def set_incoming(inter: SurfaceInteraction, incoming) -> SurfaceInteraction:
    """SetIncomingDirection (Material.glsl:112-120): new light direction,
    new half vector, refreshed dots."""
    m = normalize(inter.outgoing + incoming)
    ndm = nndot(inter.normal, m)
    return inter._replace(
        incoming=incoming, microfacet=m,
        ndi=nndot(inter.normal, incoming),
        ndm=ndm, ndm2=ndm * ndm,
        idm=nndot(incoming, m))


def to_world(inter: SurfaceInteraction, local) -> torch.Tensor:
    """TBN * local ([..., 3] in tangent space -> world)."""
    return (inter.tangent * local[..., 0:1]
            + inter.bitangent * local[..., 1:2]
            + inter.normal * local[..., 2:3])
