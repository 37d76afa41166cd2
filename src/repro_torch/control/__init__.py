"""The control plane's pure steps that the batched replay folds into its
window loop: the detector's node track (``detector.node_track_step``) and
the forecaster's moment update (``forecast._forecast_update``).  The
stateful detector, forecaster, policy and loop come with a later slice."""
