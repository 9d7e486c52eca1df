from jstsp19.solvers.lowrank import svt, mc_svt, mc_admm  # noqa: F401
from jstsp19.solvers.rank_one import (  # noqa: F401
    mc_prior_mse,
    prior_moments,
    rank_one_fit,
    rank_one_se,
)
from jstsp19.solvers.sparse import soft_threshold, sparse_admm  # noqa: F401
from jstsp19.solvers.admm import (  # noqa: F401
    proposed_admm,
    proposed_admm_angles,
    admm_hyperparams,
)
from jstsp19.solvers.lsq import ls_estimate  # noqa: F401
from jstsp19.solvers.omp import (  # noqa: F401
    cosamp,
    omp,
    omp_gram,
    omp_mmv,
    omp_td,
)
from jstsp19.solvers.estim import (  # noqa: F401
    CAwgnPrior,
    SparsePrior,
    CAwgnLikelihood,
    AwgnPrior,
    SoftThreshPrior,
    CGMPrior,
    LaplacePrior,
    UnifPrior,
    NNGMPrior,
    SNIPEPrior,
    EllpPrior,
    DiscretePrior,
    GroupSparsePrior,
    ProbitLikelihood,
    LogitLikelihood,
    RobustProbitLikelihood,
    RobustLogitLikelihood,
    TDistLikelihood,
    MultiLogitLikelihood,
    PoissonLikelihood,
    QuantizedLikelihood,
    OutlierLikelihood,
    AwbgnLikelihood,
    TruthReporterPrior,
    LaplaceLikelihood,
    MagnitudeLikelihood,
    DiracPrior,
    NullPrior,
    ElasticNetPrior,
    NNSoftThreshPrior,
    MixPrior,
    ConcatPrior,
    DiracLikelihood,
    MaskedLikelihood,
    GaussMixLikelihood,
    CMultAwgnLikelihood,
    HingeLikelihood,
    ConcatLikelihood,
    BGZeroMeanPrior,
    EllpDMMPrior,
    SoftThreshDMMPrior,
    FxnhandlePrior,
    MultiSNIPEPrior,
    L1Likelihood,
    NLLikelihood,
)
from jstsp19.solvers.vamp import (  # noqa: F401
    cawgn_likelihood_mse,
    mc_likelihood_mse,
    vamp_glm,
    vamp_glm_se,
    vamp_mmwave,
)
from jstsp19.solvers.gamp import gamp, fista, amp, amp_est, sure_amp  # noqa: F401
from jstsp19.solvers.gamp_full import (  # noqa: F401
    GampOptions,
    GampState,
    GampEstFin,
    gamp_est,
)
from jstsp19.solvers.vamp_slm import vamp_slm, vamp_slm_se  # noqa: F401
from jstsp19.solvers.bigamp import (  # noqa: F401
    bigamp,
    bigamp_mc,
    bigamp_rpca,
    em_bigamp_mc,
    em_bigamp_dl,
)
from jstsp19.solvers.bigamp_full import (  # noqa: F401
    BigAmpOptions,
    bigamp_pev,
    bigamp_lite,
)
from jstsp19.solvers.pbigamp import pbigamp, em_pbigamp  # noqa: F401
from jstsp19.solvers.gamp_se import (  # noqa: F401
    EstimInAvg,
    AwgnOutAvg,
    MCOutAvg,
    estim_in_avg,
    gamp_se,
    bg_sampler,
    s_transform,
)
from jstsp19.solvers.hutamp import hutamp  # noqa: F401
from jstsp19.solvers.em import em_bg_vamp, em_gm_vamp, em_nngm_gamp  # noqa: F401
from jstsp19.solvers.turbo import (  # noqa: F401
    turbo_markov_vamp,
    turbo_gauss_markov_vamp,
    turbo_mrf_vamp,
)
from jstsp19.solvers.turbo_em import (  # noqa: F401
    em_turbo_markov_vamp,
    em_turbo_gauss_markov_vamp,
    turbo_mrf3d_vamp,
    turbo_mrf_arb_vamp,
    markov_fb,
)
