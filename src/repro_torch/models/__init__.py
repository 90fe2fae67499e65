"""Dense GQA decoder layers and model assembly."""
