from jstsp19.channel.widemmwave import (  # noqa: F401
    wideband_mmwave_channel,
    dft_dictionary,
    ula_steering,
    truncated_laplacian,
    beamspace,
    taps_to_subcarriers,
    channel_from_taps,
)
