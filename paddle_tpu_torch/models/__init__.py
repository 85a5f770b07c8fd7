from .llama import LlamaConfig, LlamaForCausalLM, LlamaPretrainingCriterion

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaPretrainingCriterion"]
