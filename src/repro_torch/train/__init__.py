"""LoRA train and eval steps."""
