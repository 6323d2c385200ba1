"""Canny hysteresis as a Pallas kernel through Triton (GPU candidate).

Same result as ``ops.canny.hysteresis``: every candidate pixel 8-connected
to a strong pixel.  The XLA form runs 8 dilations of the whole image per
while-loop trip and sends a predicate to the host every trip.  Here each
launch runs a tile-local fixpoint instead:

- one program per (BH, BW) tile; it reads its tile and the 8 shifted
  neighbour views (a 1-pixel halo) straight from the output ref, grows
  ``reach |= cand & dilate(reach)`` and writes the tile back, then
  ``debug_barrier`` makes the block's writes visible before the next step;
- the step repeats until the tile stops changing.  Halo pixels owned by
  other tiles may be stale, but growth is monotone, so a stale halo only
  delays convergence to a later launch;
- a tile that changed sets a flag (``atomic_max`` on 0/1, i.e. an OR; it
  is also what interpret mode can execute), and the caller relaunches the
  kernel until a launch leaves the flag clear.

Images are flattened to (H*W,) int32 so every view is a masked pointer
load of a 2-D index block.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BH, BW = 32, 64  # tile shape (powers of two, as Triton requires)
_NEIGHBOURS = tuple(
    (dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)
)


def _kernel(cand_ref, reach_in_ref, flag_in_ref, reach_ref, flag_ref, *,
            h: int, w: int, max_local: int, barrier: bool):
    del reach_in_ref, flag_in_ref  # aliased to reach_ref / flag_ref
    rows = pl.program_id(0) * BH + jnp.arange(BH, dtype=jnp.int32)[:, None]
    cols = pl.program_id(1) * BW + jnp.arange(BW, dtype=jnp.int32)[None, :]
    inside = (rows < h) & (cols < w)
    idx = rows * w + cols
    cand = plgpu.load(cand_ref.at[idx], mask=inside, other=0)
    reach0 = plgpu.load(reach_ref.at[idx], mask=inside, other=0)

    def grow(reach):
        near = jnp.zeros_like(reach)
        for dy, dx in _NEIGHBOURS:
            r, c = rows + dy, cols + dx
            ok = inside & (r >= 0) & (r < h) & (c >= 0) & (c < w)
            near = near | plgpu.load(
                reach_ref.at[r * w + c], mask=ok, other=0
            )
        return reach | (cand & near)

    def cond(state):
        _, changed, it = state
        return changed & (it < max_local)

    def body(state):
        reach, _, it = state
        grown = grow(reach)
        plgpu.store(reach_ref.at[idx], grown, mask=inside)
        if barrier:  # the interpreter runs one program at a time
            plgpu.debug_barrier()
        return grown, jnp.max(grown - reach) > 0, it + 1  # grown >= reach

    reach, _, _ = jax.lax.while_loop(
        cond, body, (reach0, jnp.bool_(True), jnp.int32(0))
    )
    changed = jnp.max(reach - reach0)  # 0 or 1: growth is monotone
    plgpu.atomic_max(flag_ref, (0,), changed)


def _launch(cand, reach, h: int, w: int, interpret: bool):
    """One launch over all tiles: (reach', flag) with flag 1 if any tile
    grew."""
    grid = (pl.cdiv(h, BH), pl.cdiv(w, BW))
    # Under shard_map every output must state the mesh axes it varies over
    # (check_vma): those of the operands.
    vma = jax.typeof(cand).vma | jax.typeof(reach).vma
    flag0 = jnp.zeros((1,), jnp.int32) + reach[:1] * 0  # reach's vma
    return pl.pallas_call(
        functools.partial(
            _kernel, h=h, w=w, max_local=BH * BW, barrier=not interpret
        ),
        out_shape=(
            jax.ShapeDtypeStruct(reach.shape, jnp.int32, vma=vma),
            jax.ShapeDtypeStruct((1,), jnp.int32, vma=vma),
        ),
        grid=grid,
        input_output_aliases={1: 0, 2: 1},
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="canny_hysteresis_tile",
    )(cand, reach, flag0)


def hysteresis_triton(
    cand: jax.Array, strong: jax.Array, interpret: bool = False
) -> jax.Array:
    """Drop-in for ``ops.canny.hysteresis`` on (H, W) bool masks."""
    h, w = cand.shape
    c = cand.reshape(-1).astype(jnp.int32)

    def cond(state):
        _, flag, it = state
        return (flag > 0) & (it < h * w)

    def body(state):
        reach, _, it = state
        reach, flag = _launch(c, reach, h, w, interpret)
        return reach, flag[0], it + 1

    zero = strong.sum().astype(jnp.int32) * 0  # input-derived carries
    with jax.named_scope("canny_hysteresis"):
        reach, _, _ = jax.lax.while_loop(
            cond, body, (strong.reshape(-1).astype(jnp.int32), zero + 1, zero)
        )
    return reach.reshape(h, w) > 0
