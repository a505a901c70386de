"""Device-mesh parallelism of the port: ranks, the (data, model) mesh,
sharding rules and the trainers' collectives (port of `vit_ad_tpu/parallel`)."""

from vit_ad_tpu_torch.parallel.mesh import create_mesh  # noqa: F401
