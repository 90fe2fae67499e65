"""LoRA adapters: classic leaves and paged multi-tenant leaves."""
