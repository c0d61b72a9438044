"""Multi-device execution over ``torch.distributed``: the ('config', 'z')
mesh, the collectives of the sharded paths, and a helper that starts ranks.

The JAX package shards with GSPMD (``heatflow_tpu/parallel/sharding.py``): a
global array is laid out over a device mesh and XLA inserts the halo
exchanges and the result gather. Here every rank is one process, and every
collective is written out:

* **config axis** (data parallelism): each rank integrates its shard of a
  sweep's batch with the engine it would run on one device; the only
  collective is the gather of the results, ``all_gather`` into rank order;
* **z axis** (domain decomposition): each rank holds Nz/zs rows of one
  problem's stencils, masks and fields. A stencil apply pads the local slab
  with one row of each neighbour (:meth:`ZAxis.halo`); a z-sum, such as a
  CG dot, is a local partial sum, gathered and added in rank order
  (:meth:`ZAxis.dots`), so that every rank holds the same bits (not the
  single-device sum's: the grouping differs).

Ranks are laid out as in the JAX package, rank = c·zs + z. Every rank calls
a sharded entry point with the same full inputs and gets the full result.
No ``all_reduce`` decides a result's bits.

Transport: NCCL moves device memory. gloo moves host memory: under gloo a
CUDA tensor is copied to the host for each collective and back. That is
gloo's transport, and how several ranks share one card.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from heatflow_tpu_torch.ops.cg import pcg_fixed
from heatflow_tpu_torch.ops.stencil import apply_stencil
from heatflow_tpu_torch.utils import pad_to_multiple, resolve_device


class DeviceMesh:
    """A ('config', 'z') mesh over the default process group: ``shape``
    ({'config': nc, 'z': zs}), ``axis_names``, this rank's ``coords``, its
    ``device`` and one process group per axis (the ranks that share this
    rank's other coordinate)."""

    axis_names = ("config", "z")

    def __init__(self, n_config: int, z_shards: int, device: torch.device):
        self.shape = {"config": n_config, "z": z_shards}
        self.rank = dist.get_rank()
        self.coords = {"config": self.rank // z_shards,
                       "z": self.rank % z_shards}
        self.device = device
        self.backend = dist.get_backend()
        self.groups = {}
        # every rank creates every group, in the same order
        for z in range(z_shards):
            g = dist.new_group([c * z_shards + z for c in range(n_config)])
            if z == self.coords["z"]:
                self.groups["config"] = g
        for c in range(n_config):
            g = dist.new_group([c * z_shards + z for z in range(z_shards)])
            if c == self.coords["config"]:
                self.groups["z"] = g

    @property
    def size(self) -> int:
        return self.shape["config"] * self.shape["z"]

    def __repr__(self) -> str:
        return (f"DeviceMesh(config={self.shape['config']}, "
                f"z={self.shape['z']}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    def all_gather(self, x: torch.Tensor, axis: str) -> list[torch.Tensor]:
        """``x`` of every rank along ``axis``, in rank order (each rank's
        ``x`` has the same shape and dtype)."""
        t = x.detach().contiguous()
        host = self.backend == "gloo" and t.is_cuda
        if host:
            t = t.cpu()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=self.groups[axis])
        return [p.to(x.device) for p in parts] if host else parts

    def gather(self, x: torch.Tensor, axis: str, dim: int = 0
               ) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated along ``dim``."""
        return torch.cat(self.all_gather(x, axis), dim=dim)

    def config_slice(self, n: int) -> slice:
        """This rank's lanes of a batch of ``n`` (a multiple of the
        'config' size)."""
        per = n // self.shape["config"]
        c = self.coords["config"]
        return slice(c * per, (c + 1) * per)


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` as a :class:`DeviceMesh`, or a TypeError naming what it
    got; a mesh whose rank count differs from the world raises."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh= takes a heatflow_tpu_torch.parallel "
                        f"DeviceMesh (config_mesh), not "
                        f"{type(mesh).__name__}")
    if not dist.is_initialized() or mesh.size != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size} ranks outside its world "
                         "(the process group it was built on is gone)")
    return mesh


def config_mesh(n_devices: int | None = None, *, z_shards: int = 1,
                devices=None, device="cuda") -> DeviceMesh:
    """A ('config', 'z') mesh over the initialized default process group
    (:func:`spawn`, ``multihost.initialize`` or ``torchrun``); every rank
    calls it. ``n_devices`` (default: the world size, or ``len(devices)``)
    must equal the world size. ``z_shards=1``: config parallelism only.

    Rank r runs on ``devices[r]`` when given, else on
    ``cuda:(local_rank % device_count)`` (ranks share cards when there are
    more ranks than cards), or on the CPU when ``device='cpu'``."""
    if not dist.is_initialized():
        raise RuntimeError("config_mesh needs an initialized process group "
                           "(parallel.spawn, multihost.initialize or "
                           "torchrun)")
    world = dist.get_world_size()
    if devices is not None:
        devices = list(devices)
    n = n_devices if n_devices is not None else (
        len(devices) if devices is not None else world)
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} "
                         f"ranks; this world has {world}")
    if n % z_shards:
        raise ValueError(f"{n} devices not divisible into "
                         f"z_shards={z_shards}")
    if devices is not None:
        dev = resolve_device(devices[dist.get_rank()])
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DeviceMesh(n // z_shards, z_shards, dev)


class ZAxis:
    """One problem's z rows over the mesh's 'z' group: this rank holds rows
    [lo, hi) of Nz (``nz`` must divide by the axis size)."""

    def __init__(self, mesh: DeviceMesh, nz: int, nr: int):
        zs = mesh.shape["z"]
        if nz % zs:
            raise ValueError(f"Nz={nz} not divisible by the 'z' axis size "
                             f"{zs}")
        self.mesh, self.nz, self.nr = mesh, nz, nr
        self.n_rows = nz // zs
        self.lo = mesh.coords["z"] * self.n_rows
        self.hi = self.lo + self.n_rows

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full (..., Nz, Nr) tensor."""
        return x[..., self.lo:self.hi, :].contiguous()

    def halo(self, u: torch.Tensor) -> torch.Tensor:
        """The local slab (..., n_rows, Nr) with one row of each neighbour
        above and below, zeros past the global edges (the stencil apply's
        zero fill): built on an ``all_gather`` of every rank's two edge
        rows."""
        z, zs = self.mesh.coords["z"], self.mesh.shape["z"]
        edges = torch.stack([u[..., 0, :], u[..., -1, :]], dim=-2)
        parts = self.mesh.all_gather(edges, "z")
        zero = torch.zeros_like(u[..., :1, :])
        below = parts[z - 1][..., 1:2, :] if z > 0 else zero
        above = parts[z + 1][..., 0:1, :] if z < zs - 1 else zero
        return torch.cat([below, u, above], dim=-2)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ of every rank's ``x`` over the 'z' group, in rank order."""
        parts = self.mesh.all_gather(x, "z")
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def dots(self, *pairs) -> tuple:
        """The per-lane dots of pairs of (..., Nz, Nr) fields held as slabs:
        local partial sums, gathered in one collective and added in rank
        order (the CG's ``dot=`` hook)."""
        parts = torch.stack([(a * b).sum(dim=(-2, -1)) for a, b in pairs])
        return tuple(self.sum(parts))

    def gather(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The full tensor from every rank's rows along ``dim``."""
        return self.mesh.gather(x, "z", dim=dim)

    def full(self, fn):
        """``fn`` of a full field, applied to slabs: gather the rows, run
        ``fn`` on the full field (the same on every rank) and keep this
        rank's rows. The replicated form of the preconditioners that couple
        rows (z-line, ADI, multigrid)."""
        return lambda r: self.rows(fn(self.gather(r)))

    def local_ids(self, flat_ids: torch.Tensor):
        """(local flat ids, owner z rank) of global flat node ids; the ids
        of nodes another rank owns point at node 0 of the slab."""
        row = flat_ids // self.nr
        owner = row // self.n_rows
        mine = owner == self.mesh.coords["z"]
        local = torch.where(mine, flat_ids - self.lo * self.nr,
                            torch.zeros_like(flat_ids))
        return local, owner

    def owned(self, x: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (..., K) gathered, entry k taken from rank
        ``owner[k]``: the values read on the ranks that own their rows."""
        parts = torch.stack(self.mesh.all_gather(x, "z"))
        idx = owner.to(x.device).reshape((1,) * x.ndim + (-1,))
        idx = idx.expand((1,) + x.shape)
        return torch.gather(parts, 0, idx)[0]


def shard_batch(mesh: DeviceMesh, tree):
    """This rank's slices of a (nested) tuple, list or dict of full batched
    arrays: axis 0 over 'config'; for rank-3+ arrays (B, ..., Nz, Nr) the Nz
    axis (second-to-last) over 'z' too. Tensors on the mesh's device."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    x = torch.as_tensor(tree, device=mesh.device)
    if x.ndim >= 1:
        x = x[mesh.config_slice(x.shape[0])]
    if x.ndim >= 3 and mesh.shape["z"] > 1:
        x = ZAxis(mesh, x.shape[-2], x.shape[-1]).rows(x)
    return x.contiguous()


def batch_step_sharded(mesh: DeviceMesh, *, iters: int = 8):
    """One batched backward-Euler step over per-config operators under
    ('config', 'z') sharding, fixed-count PCG: ``step(A, M_op, free, g, u)``
    with A / M_op (B, 7, Nz, Nr), free (Nz, Nr), g / u (B, Nz, Nr), the same
    full arrays on every rank; returns the full u_next (B, Nz, Nr)."""
    zs = mesh.shape["z"]

    def step(A, M_op, free, g, u):
        A, M_op, g, u = shard_batch(mesh, (A, M_op, g, u))
        free = torch.as_tensor(free, dtype=u.dtype, device=mesh.device)
        zax = None
        if zs > 1:
            zax = ZAxis(mesh, free.shape[-2], free.shape[-1])
            free = zax.rows(free)
        halo = None if zax is None else zax.halo
        with torch.no_grad():
            s = torch.rsqrt(torch.where(A[:, 0] > 0, A[:, 0],
                                        torch.ones_like(A[:, 0]))) * free \
                + (1.0 - free)
            apply_s = lambda y: s * apply_stencil(A, s * y, halo=halo)
            b = (apply_stencil(M_op, u, halo=halo)
                 - apply_stencil(A, g, halo=halo)) * s
            y0 = (u / torch.where(s > 0, s, torch.ones_like(s))) * free
            sol = pcg_fixed(apply_s, b, y0, mask=free, iters=iters,
                            dot=None if zax is None else zax.dots)
            out = sol.x * s * free + g
        if zax is not None:
            out = zax.gather(out)
        return mesh.gather(out, "config")

    return step


# ----------------------------------------------------------------------
# starting ranks
# ----------------------------------------------------------------------

def default_backend(device, n_ranks: int = 1) -> str:
    """'nccl' for CUDA ranks with a card each, 'gloo' for the CPU and for
    ranks that share cards (NCCL takes one rank a card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"


def _rank_main(rank, fn, args, nprocs, backend, device, store, outdir,
               timeout):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(nprocs))
    torch.set_num_threads(1)      # ranks share the host's cores
    try:
        if backend is not None:
            if torch.device(device).type == "cuda":
                torch.cuda.set_device(rank % torch.cuda.device_count())
            kw = {} if timeout is None else dict(
                timeout=timedelta(seconds=timeout))
            dist.init_process_group(backend, init_method=f"file://{store}",
                                    world_size=nprocs, rank=rank, **kw)
        result = fn(*args)
        with open(os.path.join(outdir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(outdir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, *, backend: str | None = None, device="cuda",
          args: tuple = (), timeout: float | None = 120.0,
          init: bool = True) -> list:
    """Run ``fn(*args)`` in ``nprocs`` new processes, one rank each, and
    return their results in rank order.

    The ranks start with ``torch.multiprocessing`` ('spawn') and join one
    process group over a ``file://`` store in a fresh temporary directory,
    so no port is chosen and concurrent calls cannot collide; ``backend``
    defaults to 'nccl' for CUDA ranks with a card each and 'gloo' otherwise
    (:func:`default_backend`; gloo on CUDA lets several ranks share one
    card). Rank r runs on card ``r % device_count``. ``init=False`` leaves the
    group to ``fn`` (``multihost.initialize``). ``fn`` must be importable by
    module name; its result is pickled back. Each rank runs one CPU thread.
    A rank that raises, or a call that outlives ``timeout`` seconds (None:
    no limit, and the process group's default for its collectives), fails
    the whole call with that rank's traceback, and no rank is left
    running."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="hf_spawn_")
    if init and backend is None:
        backend = default_backend(device, nprocs)
    ctx = mp.start_processes(
        _rank_main, nprocs=nprocs, join=False, start_method="spawn",
        args=(fn, args, nprocs, backend if init else None, device,
              os.path.join(tmp, "store"), tmp, timeout))
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} "
                                   f"outlived {timeout:.0f} s")
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        err = os.path.join(tmp, f"{e.error_index}.err")
        msg = open(err).read() if os.path.exists(err) else str(e)
        raise RuntimeError(f"rank {e.error_index} of {fn.__name__} "
                           f"failed:\n{msg}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def gather_counts(mesh: DeviceMesh, counts: list, B: int) -> list:
    """Per-step (B_local,) counts of this rank's lanes -> per-step (B,)
    counts of the whole batch (gathered into rank order, cut back to B)."""
    if not counts:
        return []
    full = mesh.gather(torch.stack(list(counts)), "config", dim=1)[:, :B]
    return list(full)


def shard_configs(mesh: DeviceMesh, local):
    """The config-sharded form of a batched call ``local(ks, fs, **lists)``
    that runs this rank's lanes on its device (``lists``: the per-step
    count lists it fills, such as ``iters_out``). The returned call takes
    the full batch on every rank: the batch is padded to the 'config' size
    (``pad_to_multiple``), this rank runs its lanes, and the results (a
    tensor, or the watch / band / axis of a dict, lanes first) are gathered
    into rank order and cut back to B on every rank, each count list
    filled with the whole batch's counts. ``local``'s attributes
    (``times``, ``shape``, ``segment``, ...) carry over; ``segment`` keeps
    working on this rank's shard."""
    def simulate_batch(sample_k, fwhm, **lists):
        ks = np.atleast_1d(np.asarray(sample_k))
        fs = np.atleast_1d(np.asarray(fwhm))
        B, nc = len(ks), mesh.shape["config"]
        ks, fs = pad_to_multiple(ks, nc), pad_to_multiple(fs, nc)
        mine = mesh.config_slice(len(ks))
        counts = {k: [] for k, v in lists.items() if v is not None}
        out = local(ks[mine], fs[mine], **counts)
        for k, lst in counts.items():
            lists[k].extend(gather_counts(mesh, lst, B))
        gather = lambda t: mesh.gather(t, "config")[:B]
        if isinstance(out, dict):
            return {k: gather(v) if k in ("watch", "band", "axis") else v
                    for k, v in out.items()}
        return gather(out)

    simulate_batch.__dict__.update(local.__dict__)
    simulate_batch.mesh = mesh
    return simulate_batch
