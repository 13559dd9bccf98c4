from .tabular import (ADULT_SIZES, CPS_SIZES, LOANS_SIZES, adult_domain,
                      cps_domain, loans_domain, marginals_from_records,
                      mixture_marginals, synth_domain, synthetic_records)
from .tokens import synthetic_lm_batches
