"""Scale-out: shot meshes and collectives over ``torch.distributed``,
Monte-Carlo checkpoints and elastic recovery."""
