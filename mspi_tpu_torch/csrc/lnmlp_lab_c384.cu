// The LN+MLP kernel lab's bodies at C = 384 (lnmlp_lab.cuh): a translation
// unit of their own, built beside the other widths.

#include "lnmlp_lab.cuh"

cudaError_t mspi::ln_mlp_lab_c384(const LabCall& c) { return launch_ln_mlp_lab<384>(c); }
