"""CGM data layer (numpy copies of ``repro.data``): synthetic twins of
the paper's four datasets, sliding-window featurization (L=12 history ->
H=6 horizon), per-patient normalization, and the federated loader that
stacks patients into padded ``(N, m, L)`` node arrays
(``load_federated_dataset``).  Same seeds, bitwise the same arrays."""
from repro_torch.data.synth import DATASET_SPECS, generate_patient_series, generate_dataset
from repro_torch.data.windowing import make_windows, split_by_time, zscore_stats, normalize
from repro_torch.data.pipeline import PatientData, FederatedData, load_federated_dataset, batch_iterator
