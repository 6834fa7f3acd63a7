"""VLA subsystem of the port: hybrid re-ranking of grasp candidates with
a vision-language model, for serving and LoRA training
(``vla/trainer.py``, ``vla/llava_trainer.py``, ``vla/experiments.py``).

Exports the same public names as ``leafgrasp_tpu.vla``, with "torch"
where the JAX package says "jax": the checkpoint reader
(``vla/checkpoint_io.py``) and weight-only int8 / int4 serving
(``vla/quant.py``) among them.
"""

from leafgrasp_tpu_torch.vla.hybrid import (HybridGraspSelector,
                                            HybridSelector,
                                            confidence_weights,
                                            selection_strategy)
from leafgrasp_tpu_torch.vla.confidence import (ConfidenceManager,
                                                calculate_confidence)
from leafgrasp_tpu_torch.vla.processor import (VLAProcessor, StubScorer,
                                               HeuristicScorer,
                                               TinyVLAScorer, build_prompt,
                                               parse_score)
from leafgrasp_tpu_torch.vla.trainer import (VLATrainer,
                                             make_synthetic_vla_dataset,
                                             spearman_correlation)
from leafgrasp_tpu_torch.vla.lm import (TinyVLA, VLAModelConfig,
                                        ByteTokenizer, greedy_generate,
                                        init_vla)
from leafgrasp_tpu_torch.vla.llava_torch import (LlavaTorch,
                                                 LlavaTorchConfig,
                                                 config_from_hf,
                                                 convert_hf_llava_state_dict,
                                                 greedy_generate_llava)
from leafgrasp_tpu_torch.vla.llava_runtime import (LlavaTorchScorer,
                                                   load_llava_from_hf,
                                                   preprocess_image)
from leafgrasp_tpu_torch.vla.checkpoint_io import (SentencePieceTokenizer,
                                                   load_llava_checkpoint,
                                                   read_safetensors,
                                                   write_safetensors)
from leafgrasp_tpu_torch.vla.quant import (QuantDense, QuantLoRADense,
                                           quantize_llava_variables)

__all__ = [
    "HybridGraspSelector", "HybridSelector", "confidence_weights",
    "selection_strategy", "ConfidenceManager", "calculate_confidence",
    "VLAProcessor", "StubScorer", "HeuristicScorer", "TinyVLAScorer",
    "build_prompt", "parse_score", "VLATrainer",
    "make_synthetic_vla_dataset", "spearman_correlation", "TinyVLA",
    "VLAModelConfig",
    "ByteTokenizer", "greedy_generate", "init_vla", "LlavaTorch",
    "LlavaTorchConfig", "config_from_hf", "convert_hf_llava_state_dict",
    "greedy_generate_llava", "LlavaTorchScorer", "load_llava_from_hf",
    "preprocess_image", "SentencePieceTokenizer", "load_llava_checkpoint",
    "read_safetensors", "write_safetensors", "QuantDense", "QuantLoRADense",
    "quantize_llava_variables",
]
