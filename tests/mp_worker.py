"""Worker for test_multiprocess.py: one of two `jax.distributed` processes
jointly running the sharded scan-to-map alignment over a 2-device global
CPU mesh (1 device per process, collectives over Gloo)."""

import os
import sys

proc_id = int(sys.argv[1])
port = sys.argv[2]
out_path = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)  # exactly one local device per process

import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=proc_id)

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_sharded_mapping import _problem  # noqa: E402
from vloam.parallel.sharded_mapping import sharded_map_alignment  # noqa: E402

rng = np.random.default_rng(16833)
cfg, map_corner, map_surf, c_stack, s_stack, q_true, t_true = _problem(rng)

devs = jax.devices()
assert len(devs) == 2, devs
mesh = Mesh(np.asarray(devs), ("data",))


def make_global(arr, spec):
    arr = np.asarray(arr)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sharding,
                                       lambda idx: arr[idx])


def even(arr):
    n = len(arr) // 2 * 2
    return np.asarray(arr[:n])


c_stack, s_stack = even(c_stack), even(s_stack)
map_corner, map_surf = even(map_corner), even(map_surf)
ones = lambda a: np.ones(len(a), bool)

x0 = jnp.asarray([0, 0, 0, 1, 0, 0, 0], jnp.float32)
x, counts = sharded_map_alignment(
    mesh,
    make_global(c_stack.astype(np.float32), P("data")),
    make_global(ones(c_stack), P("data")),
    make_global(s_stack.astype(np.float32), P("data")),
    make_global(ones(s_stack), P("data")),
    make_global(map_corner.astype(np.float32), P("data")),
    make_global(ones(map_corner), P("data")),
    make_global(map_surf.astype(np.float32), P("data")),
    make_global(ones(map_surf), P("data")),
    x0, cfg, return_counts=True,
)
x_np = np.asarray(x)  # replicated output: every process holds a replica
if proc_id == 0:
    np.savez(out_path, x=x_np,
             q_true=q_true.as_quat(), t_true=t_true)
print(f"proc {proc_id} done x={np.round(x_np, 4)}", flush=True)
