"""Geometry and math core: skeleton model, SE(3) transforms,
Procrustes/Umeyama alignment, fisheye camera models, temporal filtering
and bilinear sampling, batched over leading axes; and the kernels'
wrappers (imported from their own modules).  `ops.umeyama` stays the
module (the function is `ops.umeyama.umeyama`), where the JAX package's
re-export rebinds the name to the function."""

from globalegomocap_tpu_torch.ops.skeleton import (  # noqa: F401
    BONE_LINES,
    JOINT_NAMES,
    KINEMATIC_PARENTS,
    MEAN3D_MM,
    NUM_JOINTS,
    bone_lengths,
    mean_bone_lengths,
    skeleton_resize,
)
from globalegomocap_tpu_torch.ops.transforms import (  # noqa: F401
    invert_se3,
    quat_trans_to_matrix,
    relative_global_pose,
    relative_to_global_pose,
    transform_pose,
)
from globalegomocap_tpu_torch.ops.umeyama import umeyama_align  # noqa
from globalegomocap_tpu_torch.ops.filtering import (  # noqa: F401
    gaussian_filter1d, one_euro_filter)
from globalegomocap_tpu_torch.ops.sampling import (  # noqa: F401
    grid_sample_bilinear)
