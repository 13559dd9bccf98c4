from .tabular import (ADULT_SIZES, adult_domain, marginals_from_records,
                      mixture_marginals, synth_domain, synthetic_records)
