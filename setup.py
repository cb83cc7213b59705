"""Package setup — console scripts mirror the reference's CLI surface
(``/root/reference/setup.py:35-70``)."""

from setuptools import find_packages, setup

TRAIN_EXTENSIONS = [
    "multihead", "sequential", "rehearsal", "ewc", "ewc_vit", "ewc_unet",
    "ewc_ln", "rw", "lwf", "mib", "plop", "pod", "frozen_vit", "frozen_nonln",
    "frozen_unet", "frozen_body_seq", "froz_ewc", "ownm1", "ownm2", "ownm3",
    "ownm4",
]

console_scripts = [
    f"nnUNet_train_{ext} = lifelong_nnunet_tpu.run.run_training:main_{ext}"
    for ext in TRAIN_EXTENSIONS
] + [
    # reference console-script name for the frozen-body sequential trainer
    # (/root/reference/setup.py: nnUNet_train_body_froz -> main_frozen_body_seq)
    "nnUNet_train_body_froz = lifelong_nnunet_tpu.run.run_training:main_frozen_body_seq",
    "nnUNet_plan_and_preprocess = lifelong_nnunet_tpu.run.plan_and_preprocess:main",
    "nnUNet_evaluate = lifelong_nnunet_tpu.run.run_evaluation:main",
    "nnUNet_evaluate2 = lifelong_nnunet_tpu.run.run_evaluation:main2",
    "nnUNet_inference = lifelong_nnunet_tpu.run.run_inference:main",
    # the PyTorch port (lifelong_nnunet_tpu_torch/): serving and training
    "nnUNet_torch_inference = lifelong_nnunet_tpu_torch.run.run_inference:main",
] + [
    f"nnUNet_torch_train_{ext} = lifelong_nnunet_tpu_torch.run.run_training:main_{ext}"
    for ext in ("multihead", "sequential", "rehearsal", "base_v2", "ewc", "ewc_vit",
                "ewc_unet", "ewc_ln", "rw", "frozen_vit", "frozen_nonln", "frozen_unet",
                "frozen_body_seq", "froz_ewc")
] + [
    "nnUNet_torch_train_body_froz = "
    "lifelong_nnunet_tpu_torch.run.run_training:main_frozen_body_seq",
    "nnUNet_torch_train_vit = lifelong_nnunet_tpu_torch.run.run_training_vit:main",
] + [
    "nnUNet_parameter_search = lifelong_nnunet_tpu.run.run_param_search:main",
    "nnUNet_train_vit = lifelong_nnunet_tpu.run.run_training_vit:main",
    "nnUNet_prepare_cascade = lifelong_nnunet_tpu.run.prepare_cascade:main",
    "nnUNet_dataset_label_mapping = lifelong_nnunet_tpu.scripts.dataset_label_mapping:main",
    "nnUNet_update_checkpoints = lifelong_nnunet_tpu.scripts.update_checkpoints:main",
    "nnUNet_update_checkpoints_all = lifelong_nnunet_tpu.scripts.update_checkpoints:main_all",
    "nnUNet_delete_tasks = lifelong_nnunet_tpu.scripts.delete_tasks:main",
    "nnUNet_join_datasets = lifelong_nnunet_tpu.scripts.join_datasets:main",
]

setup(
    name="lifelong_nnunet_tpu",
    version="0.1.0",
    description=("TPU-native continual-learning medical image segmentation "
                 "framework (JAX/XLA/Pallas), capability-equivalent to "
                 "Lifelong-nnUNet"),
    packages=find_packages(include=["lifelong_nnunet_tpu*"]),
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "scipy", "scikit-learn",
                      "pandas"],
    entry_points={"console_scripts": console_scripts},
)
