from grample_tpu_torch.uai.parser import (  # noqa: F401
    parse_evidence,
    parse_mar,
    parse_model,
    preprocess,
    read_evidence_file,
    read_mar_file,
    read_model_file,
    load_model,
)
from grample_tpu_torch.uai.writer import write_mar, write_model  # noqa: F401
