// The LN+MLP kernel lab's bodies at C = 192 (lnmlp_lab.cuh): a translation
// unit of their own, built beside the other widths.

#include "lnmlp_lab.cuh"

cudaError_t mspi::ln_mlp_lab_c192(const LabCall& c) { return launch_ln_mlp_lab<192>(c); }
