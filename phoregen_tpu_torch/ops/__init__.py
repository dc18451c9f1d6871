from .schedules import (advance_schedule, cosine_beta_schedule,
                        get_beta_schedule, segment_schedule)
from .masked import (masked_softmax, masked_mean, masked_sum,
                     masked_logsumexp, index_to_log_onehot,
                     log_sample_categorical, categorical_kl, log_categorical,
                     clamped_log)
from .knn import knn_neighbors, radius_neighbors, pairwise_sq_dist
from .rbf import (gaussian_smearing, gaussian_smearing_offsets,
                  time_smearing, time_smearing_offsets,
                  angular_encoding, angular_encoding_freq_bands,
                  angular_encoding_dim)
