from grample_tpu_torch.pgm.discrete import DiscreteModel, Factor, letter26  # noqa: F401
from grample_tpu_torch.pgm.encode import EncodedModel, encode_model  # noqa: F401
from grample_tpu_torch.pgm.coloring import color_graph, moral_adjacency  # noqa: F401
