"""Models of the port (counterpart of ``repro.models``): ResNet-20/18."""
