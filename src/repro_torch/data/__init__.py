from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticImages,
    SyntheticLM,
    make_noniid_class_partition,
)
