"""The port's comm facade (``deepspeed_tpu_torch.comm``) against the
reference's ``deepspeed_tpu.comm`` and numpy.

- A rank's coordinates are the reference's ``build_mesh`` device order for
  ``{data: 2, fsdp: 2, tensor: 2}`` (a pure function: no processes).
- Mesh shapes and their errors follow ``_normalize_mesh_shape``'s, with the
  world size in place of the device count.
- In a world of 4 gloo ranks on the CPU over ``{data: 2, tensor: 2}``, every
  collective over the world, each axis and both axes equals numpy's answer
  on the ranks' inputs (small integers in f32: every sum is exact, so the
  comparison is equality); the DeviceMesh's coordinates are the facade's;
  ``ppermute`` raises, naming Queue 1 item 10; the comms log counts bytes.
- ``utils/groups`` gives the reference's group axes and widths over the
  same mesh, and each rank's index in them.
- Without a process group a process is a world of one, whose collectives
  return copies.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu import comm as jcomm
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm import comms_logging
from torch_dist_common import rank_input, run_world

MESH = {"data": 2, "tensor": 2}
WORLD = 4


def test_rank_coordinates_follow_the_reference_device_order():
    shape = {"data": 2, "fsdp": 2, "tensor": 2}
    jcomm.destroy()
    try:
        mesh = jcomm.build_mesh(shape, devices=jax.devices()[:8])
    finally:
        jcomm.destroy()
    full = comm.comm._normalize_mesh_shape(shape, 8)
    assert tuple(full[ax] for ax in comm.MESH_AXES) == mesh.devices.shape
    assert comm.MESH_AXES == tuple(mesh.axis_names)
    for idx in np.ndindex(mesh.devices.shape):
        rank = mesh.devices[idx].id
        assert comm.rank_coords(rank, full) == dict(zip(comm.MESH_AXES, idx))
        assert comm.build_mesh(shape, world_size=8, rank=rank).coords == dict(zip(comm.MESH_AXES, idx))


@pytest.mark.parametrize("shape,n", [
    (None, 4), ({"fsdp": -1}, 8), ({"data": 2, "tensor": -1}, 8), ({"fsdp": 2, "tensor": 2}, 8),
    ({"data": -1, "fsdp": -1}, 4), ({"tensor": 2}, 2),
    # errors
    ({"bogus": 2}, 4), ({"fsdp": -1, "tensor": -1}, 8), ({"fsdp": 3}, 8), ({"tensor": 3, "data": -1}, 8),
    ({"data": 2, "fsdp": 2}, 2),
])
def test_mesh_shapes_and_their_errors_are_the_reference_s(shape, n):
    def outcome(fn):
        try:
            return "ok", fn(shape, n)
        except ValueError as e:
            return "error", str(e)

    kind, ref = outcome(jcomm.comm._normalize_mesh_shape)
    got_kind, got = outcome(comm.comm._normalize_mesh_shape)
    assert got_kind == kind
    assert got == ref


def test_a_process_without_a_group_is_a_world_of_one():
    comm.destroy()
    x = torch.arange(6.0).reshape(2, 3)
    assert comm.get_world_size() == 1 and comm.get_rank() == 0 and comm.dp_world_size() == 1
    assert not comm.has_process_group()
    for out in (comm.all_reduce(x), comm.all_gather(x, axis=1), comm.reduce_scatter(x),
                comm.broadcast(x), comm.all_to_all(x, "tensor")):
        assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    assert torch.equal(comm.all_gather(x, tiled=False), x[None])
    assert comms_logging.get_msg_size(x) == 24
    with pytest.raises(RuntimeError, match="init_distributed"):
        comm.get_mesh()


def _members(rank, axes):
    """The world ranks of ``rank``'s group over ``axes``, in group-rank
    order (row-major over the axes as given)."""
    dims = tuple(comm.comm._normalize_mesh_shape(MESH, WORLD)[ax] for ax in comm.MESH_AXES)
    grid = np.arange(WORLD).reshape(dims)
    mine = np.unravel_index(rank, dims)
    pos = [comm.MESH_AXES.index(ax) for ax in axes]
    out = []
    for idx in itertools.product(*(range(dims[p]) for p in pos)):
        where = list(mine)
        for p, i in zip(pos, idx):
            where[p] = i
        out.append(int(grid[tuple(where)]))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("comm", WORLD, tmp_path_factory.mktemp("comm_world"), MESH)


def test_the_ranks_import_neither_jax_nor_the_reference(world):
    assert all(r["foreign_modules"] == [] for r in world)


def test_mesh_coordinates_are_the_device_mesh_s(world):
    full = comm.comm._normalize_mesh_shape(MESH, WORLD)
    for rank, r in enumerate(world):
        assert r["coords"] == comm.rank_coords(rank, full)
        assert r["device_mesh"] == tuple(r["coords"][ax] for ax in comm.MESH_AXES)


@pytest.mark.parametrize("group", [None, "tensor", "data", ("data", "tensor")])
def test_every_collective_equals_numpy(world, group):
    axes = comm.MESH_AXES if group is None else ((group,) if isinstance(group, str) else group)
    for rank, res in enumerate(world):
        r = res[str(group)]
        members = _members(rank, axes)
        me = members.index(rank)
        n = len(members)
        xs = [rank_input(m) for m in members]
        assert (r["rank"], r["size"]) == (me, n)
        want = {"all_reduce_sum": np.sum(xs, 0), "all_reduce_avg": np.sum(xs, 0) / n,
                "all_reduce_max": np.max(xs, 0), "all_reduce_min": np.min(xs, 0),
                "all_reduce_prod": np.prod(xs, 0),
                "all_gather_0": np.concatenate(xs, 0), "all_gather_1": np.concatenate(xs, 1),
                "all_gather_stacked": np.stack(xs, 1),
                "reduce_scatter_0": np.split(np.sum(xs, 0), n, 0)[me],
                "reduce_scatter_1": np.split(np.sum(xs, 0), n, 1)[me],
                "reduce_scatter_untiled": np.sum([rank_input(m, (n, 3)) for m in members], 0)[me],
                "broadcast": xs[-1]}
        if isinstance(group, str):
            want["all_to_all"] = np.concatenate([np.split(x, n, 0)[me] for x in xs], 1)
        for key, value in want.items():
            np.testing.assert_array_equal(r[key], value, err_msg=f"{group} {key} rank {rank}")
        assert res["input_unchanged"]


def test_ppermute_raises_naming_item_10_and_the_log_counts_bytes(world):
    for r in world:
        assert "item 10" in r["ppermute"]
        # 4 groups x 5 reductions, 3 gathers, 3 scatters, 1 broadcast; 2 all_to_alls
        assert r["comms"]["all_reduce"]["count"] == 20
        assert r["comms"]["all_gather"]["count"] == 12
        assert r["comms"]["all_to_all"]["count"] == 2
        assert r["comms"]["broadcast"]["count"] == 4
        assert r["comms"]["all_reduce"]["total_bytes"] == 20 * 4 * 8 * 4


def test_groups_are_the_reference_s_axes_and_widths(world):
    from deepspeed_tpu.utils import groups as jgroups

    jcomm.destroy()
    try:
        jcomm.init_distributed(mesh_shape=MESH, devices=jax.devices()[:WORLD], verbose=False)
        jgroups._clear()
        ref = {"expert": jgroups.initialize(ep_size=1),
               "expert_data": jgroups._get_expert_data_parallel_group(),
               "data": jgroups._get_data_parallel_group(),
               "model": jgroups._get_model_parallel_group(),
               "sequence": jgroups._get_sequence_parallel_group(),
               "sizes": (jgroups._get_data_parallel_world_size(),
                         jgroups._get_model_parallel_world_size(),
                         jgroups._get_sequence_parallel_world_size(),
                         jgroups._get_expert_parallel_world_size(),
                         jgroups._get_expert_data_parallel_world_size())}
        with pytest.raises(ValueError) as refused:
            jgroups.initialize(ep_size=2)
    finally:
        jgroups._clear()
        jcomm.destroy()
    for rank, r in enumerate(world):
        got = r["groups"]
        for key, value in ref.items():
            assert tuple(got[key]) == tuple(value), key
        coords = r["coords"]
        assert got["ranks"] == (coords["data"], coords["tensor"], 0)
        assert got["ep2"] == str(refused.value)
