"""Robot evaluation: policy adapters (SimplerEnv / WidowX), gripper
localization, SE(3) helpers and the kinematic success-rate world. Port of
``emmax_tpu/experiments``; everything here but the policy's model call is
host numpy."""
