from repro_torch.data.synthetic import (  # noqa: F401
    anisotropic,
    blobs,
    circles,
    moons,
    make_dataset,
)
