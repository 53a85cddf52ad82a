"""dp x sp HYBRID batch pipeline: the coarse-tail Amdahl mitigation.

Under pure spatial sharding the ~27-level coarse tail runs replicated on
every device — pure serial fraction (parallel/model.py prices it).
Frame pairs are independent, so a BATCH of B = n pairs can amortize it:

  phase A (coarse tail, data-parallel): one pair per chip — each chip
    runs the presmooth + every replicate-planned level group of ITS OWN
    pair with the full local engine (`shard_map` over the spatial axis
    used as a batch axis; zero collectives). B pairs' tails cost ONE
    tail of wall-clock instead of B.

  phase B (fine levels, spatially sharded): pairs processed
    sequentially, each pair's rows sharded over all n devices with the
    cost-routed relaxation (replicate/explicit@k per bucket,
    parallel.model.plan_level — the halo="auto" router). XLA inserts
    the one resharding between the phases.

The split point is the first level group the router would NOT
replicate: below it sharding pays, above it replication was pure
Amdahl.

Numerics: phase A is the unsharded engine per pair; phase B is the
verified sharded relaxation — per-pair EPE vs the unsharded solve is
bounded by the same cross-program float band as every sharded path
(tests pin <= 1e-4 mean on the 8-device CPU mesh).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from tpuflow.config import FlowConfig


def hybrid_split_group(groups, cfg: FlowConfig, n_y: int) -> int:
    """Index of the first level group the cost router would shard (all
    groups before it replicate under sp — the Amdahl tail phase A
    absorbs)."""
    from tpuflow.parallel.model import plan_level

    for gi, (bucket, _) in enumerate(groups):
        if plan_level(bucket[0], bucket[1], cfg, n_y)[0] != "replicated":
            return gi
    return len(groups)


def compiled_full_pipeline_hybrid(
    orig_shape: Tuple[int, int], B: int, mesh, y_axis: str,
    cfg: FlowConfig, split_group: int | None = None,
):
    """jit program: (B, H, W) x2 -> (B, h0, w0) x2 with the two-phase
    schedule above. B must be a multiple of mesh.shape[y_axis]."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpuflow.ops.gaussian import gaussian_smooth
    from tpuflow.parallel.model import plan_level
    from tpuflow.solver.bucketed import (
        _level_groups,
        bucket_dims,
        bucketed_level_step,
        level_schedule,
    )

    h0, w0 = orig_shape
    specs = level_schedule(w0, h0, cfg.warp_levels_count, cfg.warp_scale_factor)
    top_bucket = bucket_dims(specs[-1].width, specs[-1].height)
    h0b, w0b = top_bucket
    groups = _level_groups(specs, w0, h0, cfg)
    n_y = mesh.shape[y_axis]
    assert B % n_y == 0, (B, n_y)
    g0 = hybrid_split_group(groups, cfg, n_y) if split_group is None \
        else split_group

    row_sharding = NamedSharding(mesh, P(y_axis, None))
    repl_sharding = NamedSharding(mesh, P(None, None))
    plans = {
        bucket: plan_level(bucket[0], bucket[1], cfg, n_y)
        for bucket, _ in groups[g0:]
    }

    def constrain(a, bucket):
        if plans.get(bucket, ("",))[0] == "replicated":
            return jax.lax.with_sharding_constraint(a, repl_sharding)
        if h0b % n_y == 0 and h0b // n_y >= 16:
            return jax.lax.with_sharding_constraint(a, row_sharding)
        return a

    def relax_for(bucket):
        path, kk, _ = plans[bucket]
        if path == "replicated":
            return None
        from tpuflow.parallel.halo import relax_sharded

        def efn(f0_l, f1_w, uu, vv, sc, cfg_, kk=kk):
            return relax_sharded(
                f0_l, f1_w, uu, vv, sc, cfg_, mesh, y_axis, k_outer=kk)

        return efn

    def smooth_pad(f):
        s = gaussian_smooth(f, cfg.gaussian_sigma)
        return jnp.zeros((h0b, w0b), jnp.float32).at[:h0, :w0].set(s)

    def tail_one(f0s, f1s):
        """The replicate-planned groups of ONE pair (already smoothed +
        padded), fully local — phase A's per-chip body."""
        u = jnp.zeros((h0b, w0b), jnp.float32)
        v = jnp.zeros_like(u)
        for bucket, stacked in groups[:g0]:
            def body(carry, sc, bucket=bucket):
                return bucketed_level_step(
                    f0s, f1s, carry[0], carry[1], sc, bucket, top_bucket,
                    cfg), None

            (u, v), _ = jax.lax.scan(body, (u, v), stacked,
                                     length=stacked[0].shape[0])
        return u, v

    @jax.jit
    def run(F0, F1):
        # Presmooth ONCE per pair; both phases consume the same smoothed
        # stacks (phase A's copies can't be CSE'd across the shard_map
        # boundary — round-4 code-review finding).
        F0S = jnp.stack([smooth_pad(F0[i]) for i in range(B)])
        F1S = jnp.stack([smooth_pad(F1[i]) for i in range(B)])

        # ---- phase A: coarse tails, one pair per chip ----------------
        if g0 > 0:
            def tail_body(f0b, f1b):
                outs = [tail_one(f0b[i], f1b[i]) for i in range(B // n_y)]
                return (jnp.stack([o[0] for o in outs]),
                        jnp.stack([o[1] for o in outs]))

            U, V = shard_map(
                tail_body, mesh=mesh,
                in_specs=(P(y_axis, None, None),) * 2,
                out_specs=(P(y_axis, None, None),) * 2,
                check_vma=False,
            )(F0S, F1S)
        else:
            U = jnp.zeros((B, h0b, w0b), jnp.float32)
            V = jnp.zeros_like(U)

        # ---- phase B: fine levels, rows over all chips, pair by pair -
        out_u, out_v = [], []
        for bidx in range(B):
            f0s = constrain(F0S[bidx], None)
            f1s = constrain(F1S[bidx], None)
            u = constrain(U[bidx], None)
            v = constrain(V[bidx], None)
            for bucket, stacked in groups[g0:]:
                relax_fn = relax_for(bucket)

                def body(carry, sc, bucket=bucket, relax_fn=relax_fn):
                    uu, vv = bucketed_level_step(
                        f0s, f1s, carry[0], carry[1], sc, bucket,
                        top_bucket, cfg, relax="xla", relax_fn=relax_fn)
                    return (constrain(uu, bucket), constrain(vv, bucket)), None

                (u, v), _ = jax.lax.scan(body, (u, v), stacked,
                                         length=stacked[0].shape[0])
            out_u.append(u[:h0, :w0])
            out_v.append(v[:h0, :w0])
        return jnp.stack(out_u), jnp.stack(out_v)

    return run


def compute_flow_bucketed_hybrid(
    frames_0, frames_1, cfg: FlowConfig = None, mesh=None,
    y_axis: str = "y", split_group: int | None = None,
):
    """Solve a (B, H, W) batch with the dp-tail / sp-fine hybrid
    schedule. B is padded to a multiple of the spatial axis size by
    repeating the last pair (trimmed after). Returns DEVICE arrays.

    split_group overrides the router's tail/fine boundary (tests)."""
    from tpuflow.parallel.mesh import make_mesh

    cfg = cfg or FlowConfig()
    mesh = mesh or make_mesh()
    F0 = jnp.asarray(frames_0, jnp.float32)
    F1 = jnp.asarray(frames_1, jnp.float32)
    if F0.ndim != 3 or F0.shape != F1.shape:
        raise ValueError(f"expected (B, H, W) stacks, got {F0.shape} {F1.shape}")
    b, h0, w0 = F0.shape
    n = mesh.shape[y_axis]
    b_pad = -(-b // n) * n
    if b_pad != b:
        F0 = jnp.concatenate(
            [F0, jnp.broadcast_to(F0[-1:], (b_pad - b, h0, w0))], axis=0)
        F1 = jnp.concatenate(
            [F1, jnp.broadcast_to(F1[-1:], (b_pad - b, h0, w0))], axis=0)
    run = _compiled_hybrid_cached((h0, w0), b_pad, mesh, y_axis, cfg,
                                  split_group)
    U, V = run(F0, F1)
    return (U, V) if b_pad == b else (U[:b], V[:b])


from tpuflow.utils.envcache import env_cached as _env_cached  # noqa: E402


@_env_cached(maxsize=16)
def _compiled_hybrid_cached(orig_shape, B, mesh, y_axis, cfg, split_group,
                            *, _env=None):
    return compiled_full_pipeline_hybrid(orig_shape, B, mesh, y_axis, cfg,
                                         split_group)
