"""Multi-GPU rendering over ``torch.distributed``: one process per card, the
Morton pixel axis split into contiguous ranges (mesh.py), the forward render
per range and the train step with its gradient all-reduce (shard.py), and
the ranks of a group on one host started as processes (launch.py)."""
