"""Every family beyond smollm's dense step trains on a mesh, held
against its one-device step on CPU ranks (gloo), as
tests/test_torch_spmd.py does, and the data pipeline shards its batch;
one spawn of 4 ranks (a module fixture) runs every case of the file.
"""
import pytest

from _torch_dist import run_ranks
from _torch_spmd_ranks import _families_all


# ------------------------------------------------- the other families
WAITING = ("zamba2-7b", "xlstm-1.3b", "seamless-m4t-medium")
MESH_PLAN = [(a, ("dp", "tp"), {}) for a in WAITING] + [
    ("llava-next-34b", ("dp", "tp"), {}),
    ("olmoe-1b-7b", ("dp", "tp"), {"capacity_factor": 8.0})]
# the host mesh of 4 ranks is (1, 4): dp and fsdp with a data axis of 1
HOST_PLAN = [("smollm-135m", ("dp", "fsdp"), {}),
             ("zamba2-7b", ("dp",), {})]
# no model axis: the MoE takes its dense path, each rank on its rows
DATA_PLAN = [("olmoe-1b-7b", ("dp", "fsdp"), {})]


def _check_families(out, strategies, data: int, moe_loss: float = 2e-3):
    for arch, res in out.items():
        one = res["one"]
        moe = arch == "olmoe-1b-7b"
        for strat in strategies:
            loss, fnorm, explicit = res[strat]
            assert explicit == (strat == "dp" and not moe and data > 1), \
                (arch, strat)
            assert abs(loss - one[0]) < (moe_loss if moe else 1e-4), \
                (arch, strat, loss, one)
            assert abs(fnorm - one[1]) < 1e-4, (arch, strat, fnorm, one)
        # every family serves on the mesh (tests/test_torch_spmd_serve.py
        # holds decode too): the prefill's logits agree with one device
        assert res["serve"] <= 1e-4, (arch, res["serve"])


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """Rank 0's results of every case, from one spawn of 4 ranks."""
    return run_ranks(_families_all, 4, tmp_path_factory.mktemp("families"),
                     MESH_PLAN, [(a, ("tp",), {}) for a in WAITING],
                     HOST_PLAN, DATA_PLAN)


def test_families_train_on_the_mesh(families):
    """Beyond smollm, on a (2, 2) mesh of 4 ranks: hybrid (zamba2-7b),
    ssm (xlstm-1.3b) and encdec (seamless-m4t-medium) under dp, the
    explicit path (the model on local tensors: family-agnostic), and tp,
    the auto path (their scans on local blocks under ``local_map``: no
    strided shard, so the first step plans in seconds); vlm
    (llava-next-34b) and moe (olmoe-1b-7b) under dp and tp, the auto
    path.  Each within 1e-4 of its one-device step (loss and mean
    |final_norm|), but olmoe's loss: on the mesh its MoE takes
    ep_alltoall (capacity 8 here: nothing drops), whose aux loss is the
    mean of the shards' Switch estimators, as in the reference, not the
    global-batch one; the loss carries 0.01 of it, and the two
    estimators of an aux near 2 differ by well under 0.2: within 2e-3.
    Every family's prefill on the mesh (tp, f32) agrees with one device
    within 1e-4."""
    out = families["mesh"]
    for arch, strategies, _ in MESH_PLAN:
        _check_families({arch: out[arch]}, strategies, data=2)


def test_families_tp_on_the_model_axis(families):
    """hybrid, ssm and encdec under tp, the auto path with DTensors
    through each family's own ops (Mamba2's chunked scan, the mLSTM and
    the sLSTM, cross-attention), on a model axis of 4 ranks: within 1e-4
    of the one-device step (on (2, 2) too: the test above)."""
    _check_families(families["model_axis"], ("tp",), data=1)


def test_host_mesh_data_axis_of_one(families):
    """dp and fsdp on ``make_host_mesh()`` of 4 ranks, (1, 4): the mesh
    that ``torchrun ... -m repro_torch.launch.train`` takes.  With a data
    axis of 1 the step takes the auto path, as the reference's does
    (no explicit collectives), and agrees with the one-device step
    within 1e-4: smollm-135m under both, and a family beyond the
    transformer backbone (zamba2-7b) under dp."""
    out = families["host_mesh"]
    for arch, strategies, _ in HOST_PLAN:
        _check_families({arch: out[arch]}, strategies, data=1)


def test_moe_dense_path_on_a_data_axis(families):
    """olmoe-1b-7b under dp and fsdp on a mesh of one data axis of 4:
    with no model axis the MoE takes its dense path, each rank on its own
    rows, the aux from the router statistics averaged over the ranks
    (the global batch's, as on one device).  So the loss, aux included,
    agrees with the one-device step within 1e-4, like every other
    family's, and so does mean |final_norm|."""
    out = families["data_axis"]
    for arch, strategies, _ in DATA_PLAN:
        _check_families({arch: out[arch]}, strategies, data=4,
                        moe_loss=1e-4)


def test_pipeline_shards_the_one_device_batch(families):
    """``SyntheticLM`` with a (2, 2) mesh: every rank draws its own rows
    of the same global batch, split over the data axis, and the full
    batch equals the one-device one bit for bit (tokens, labels and a
    vlm's frontend embeddings)."""
    out = families["pipeline"]
    assert set(out["llava-next-34b"]) == {"tokens", "labels",
                                          "frontend_embeds"}
    for arch, leaves in out.items():
        for name, (placements, equal) in leaves.items():
            assert placements == "(Shard(dim=0), Replicate())", \
                (arch, name, placements)
            assert equal, (arch, name)
