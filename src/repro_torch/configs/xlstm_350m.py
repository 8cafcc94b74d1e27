"""xLSTM-350M: sLSTM + mLSTM blocks (1 sLSTM per 6 blocks), no separate
FFN (d_ff=0); recurrent state => long_500k runnable. [arXiv:2405.04517]"""
from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv=4, d_ff=0,
    vocab=50304, rope=False,
    ssm=SSMCfg(state_dim=64, head_dim=256, chunk=256, slstm_every=6),
    max_seq=524288,
)
