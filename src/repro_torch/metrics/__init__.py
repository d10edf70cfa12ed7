"""Clinical blood-glucose prediction metrics (paper §4; a numpy copy of
``repro.metrics``): RMSE, MARD, MAE, gRMSE and time lag —
``all_metrics`` bundles them."""
from repro_torch.metrics.glucose import all_metrics, grmse, mae, mard, rmse, time_lag_minutes
