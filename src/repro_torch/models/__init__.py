"""Models of the port (counterpart of ``repro.models``): ResNet-20/18, and
the decoder-only transformer (GQA, MoE) with its building blocks."""
