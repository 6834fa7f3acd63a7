"""Device meshes, sharding rules, batched, spatial, tensor and pipeline
parallelism on ``torch.distributed``: the PyTorch port of
leafgrasp_tpu/parallel/."""

from leafgrasp_tpu_torch.parallel.mesh import (make_mesh, data_sharding,
                                               replicated)
from leafgrasp_tpu_torch.parallel.sharding import (infer_param_shardings,
                                                   shard_variables,
                                                   shard_batch,
                                                   tensor_parallel_)
from leafgrasp_tpu_torch.parallel.batch import make_batched_frame_fn
from leafgrasp_tpu_torch.parallel.spatial_frame import make_sharded_frame_fn
from leafgrasp_tpu_torch.parallel.spatial import (sharded_edt,
                                                  sharded_squared_edt,
                                                  sharded_nearest_seed_rows,
                                                  sharded_shift_rows)
from leafgrasp_tpu_torch.parallel.pipeline import (split_decoder_stages,
                                                   shard_stage_params,
                                                   make_pp_llava_forward)

__all__ = ["make_mesh", "data_sharding", "replicated",
           "infer_param_shardings", "shard_variables", "shard_batch",
           "make_batched_frame_fn", "make_sharded_frame_fn",
           "sharded_edt", "sharded_squared_edt",
           "sharded_nearest_seed_rows", "sharded_shift_rows",
           "tensor_parallel_", "split_decoder_stages", "shard_stage_params",
           "make_pp_llava_forward"]
