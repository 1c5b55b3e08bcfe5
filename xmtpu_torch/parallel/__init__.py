from xmtpu_torch.parallel.mesh import make_mesh, shard_problem, sharded_tr_step

__all__ = ["make_mesh", "shard_problem", "sharded_tr_step"]
