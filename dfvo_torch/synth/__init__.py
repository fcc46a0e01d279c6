from .oracle import (  # noqa: F401
    chain_motions,
    corrupt_flow,
    make_motions,
    make_oracle_sequence,
    render_images,
    smooth_field,
    structured_flow_diff,
)
