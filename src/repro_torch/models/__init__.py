"""The LM framework's models: dense GQA blocks (attention, MLP) and the
model's serving forwards."""
