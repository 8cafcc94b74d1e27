"""DNNExplorer's core for the port: model analysis, the analytical
accelerator models and the two-level DSE engine (NumPy copies of the JAX
package's modules, which import no JAX), plus the cross-cell screen that
runs on the card (``screen.py``)."""
from .batch_eval import evaluate_rav_batch, screen_rav_batch
from .explorer import ExplorationResult, explore
from .generic_model import GenericDesign, best_generic
from .layer_arrays import PackedLayers, pack_layers
from .hw_specs import (A100_40G, A100_80G, FPGAS, GPUS, H100, KU115, TPU_V5E,
                       TPUS, VU9P, ZC706, ZCU102, FPGASpec, GPUSpec, TPUSpec)
from .local_opt import (RAV, DesignPoint, dnnbuilder_design, evaluate_rav,
                        generic_only_design)
from .netinfo import INPUT_CASES, TABLE1_NETS, LayerInfo, NetInfo, vgg16
from .pipeline_model import PipelineDesign, StageDesign, design_pipeline
from .pso import PSOConfig, PSOResult, optimize
from .search import (SearchResult, Searcher, SearchSpace, SEARCHERS,
                     hyperband_rung0, make_searcher, run_search,
                     searcher_config_for, searcher_names)

__all__ = [
    "ExplorationResult", "explore", "GenericDesign", "best_generic",
    "evaluate_rav_batch", "screen_rav_batch", "PackedLayers", "pack_layers",
    "SearchResult", "Searcher", "SearchSpace", "SEARCHERS",
    "hyperband_rung0", "make_searcher", "run_search",
    "searcher_config_for", "searcher_names",
    "A100_40G", "A100_80G", "FPGAS", "GPUS", "H100", "KU115", "TPU_V5E",
    "TPUS", "VU9P", "ZC706", "ZCU102", "FPGASpec", "GPUSpec", "TPUSpec",
    "RAV", "DesignPoint", "dnnbuilder_design",
    "evaluate_rav", "generic_only_design", "INPUT_CASES", "TABLE1_NETS",
    "LayerInfo", "NetInfo", "vgg16", "PipelineDesign", "StageDesign",
    "design_pipeline", "PSOConfig", "PSOResult", "optimize",
]
