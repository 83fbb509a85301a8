"""The distributed layer on ``torch.distributed``: one process a rank."""
