"""Models of the port (counterpart of ``repro.models``): ResNet-20/18, the
decoder-only transformer (GQA, MLA, MoE) with its building blocks, the
recurrent zamba2 (Mamba2) and xlstm, and the multimodal whisper and
llava."""
