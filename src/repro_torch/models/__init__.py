"""Dense GQA decoder: common schema helpers, layers, dense family, ModelSpec."""
