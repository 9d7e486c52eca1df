from jstsp19.frontend.beamformers import create_beamformer  # noqa: F401
from jstsp19.frontend.modulation import qam4_mod, qam4_demod  # noqa: F401
from jstsp19.frontend.quantizer import optimum_uniform_quantizer  # noqa: F401
from jstsp19.frontend.training import (  # noqa: F401
    qam4_training_frames,
    gaussian_training_frames,
    awgn,
)
from jstsp19.frontend.measurement import (  # noqa: F401
    received_frame,
    hbf,
    proposed_hbf,
    sample_omega,
    comm_system_training,
)
