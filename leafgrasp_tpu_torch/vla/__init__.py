"""VLA subsystem of the port: hybrid re-ranking of grasp candidates with
a vision-language model, for serving and LoRA training
(``vla/trainer.py``, ``vla/llava_trainer.py``, ``vla/experiments.py``).

Exports the same public names as ``leafgrasp_tpu.vla`` for what is
ported, with "torch" where the JAX package says "jax". What is not
ported yet (quantized serving, the checkpoint reader) raises an
``ImportError`` that names it.
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
    "preprocess_image",
]

# public names of leafgrasp_tpu.vla that wait for a later slice
_LATER = {
    "SentencePieceTokenizer": "the checkpoint reader (vla/checkpoint_io.py)",
    "load_llava_checkpoint": "the checkpoint reader (vla/checkpoint_io.py)",
    "read_safetensors": "the checkpoint reader (vla/checkpoint_io.py)",
    "write_safetensors": "the checkpoint reader (vla/checkpoint_io.py)",
    "QuantDense": "int8/int4 serving (vla/quant.py)",
    "QuantLoRADense": "int8/int4 serving (vla/quant.py)",
    "quantize_llava_variables": "int8/int4 serving (vla/quant.py)",
}


def __getattr__(name: str):
    if name in _LATER:
        raise ImportError(
            f"leafgrasp_tpu_torch.vla.{name} is not ported yet: "
            f"{_LATER[name]} comes with the next VLA slice of the port; "
            f"the JAX package's leafgrasp_tpu.vla.{name} is the reference")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
